#!/usr/bin/env python3
"""Drive the PyTorch port (``areal_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero and prints
no result line:

1. device   — requires CUDA; prints the card's name and power limit.
2. build    — compiles every ``areal_tpu_torch/csrc/*.cu`` with nvcc (one
              process per source, all at once).
3. kernel   — the paged decode-attention kernel against its plain PyTorch
              twin at the serving shapes of Qwen2.5-1.5B (H=12, KH=2,
              hd=128, psz=128, S=32, 28-layer stacked cache, layer 5),
              ragged lengths and shared pages, for bf16, int8 and fp8
              pages; kernel / plain / SDPA-yardstick times and the bound.
4. serve    — an ``InferenceServer`` over Qwen2.5-1.5B (full width and
              depth, random bf16 weights from a seed) answers 16 concurrent
              /generate requests; checks completeness, logprobs against a
              dense prefill, the kernel's launch count, and the version
              tags across a mid-generation weight update.
5. serve_int8 — a short second engine with int8 KV pages.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Needs one card; builds into
``areal_tpu_torch/_build/``; no network.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

# Qwen2.5-1.5B (the model bench.py serves on the TPU): full width and depth
QWEN25_15B = dict(
    vocab_size=151936,
    hidden_size=1536,
    intermediate_size=8960,
    num_layers=28,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    rope_theta=1_000_000.0,
    rms_norm_eps=1e-6,
    tie_word_embeddings=True,
    attention_bias=True,
    dtype="bfloat16",
)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp8": 1979e12}  # dense tensor-core rates
# kernel vs plain, max |diff| on O(1) outputs: the plain twin rounds logits
# and probabilities to bf16 (as the JAX twin does) while the kernel keeps
# f32 throughout; bf16 keeps 8 significant bits (2^-8 ~ 4e-3 relative),
# times a margin of 5
KERNEL_TOL = 2e-2
# served logprob vs a dense bf16 prefill of prompt+output: both paths round
# to bf16 at different points across 28 layers; on logits of O(1) spread
# that is ~1e-2 per logit, held with a margin of 10
LOGPROB_TOL = 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean ms per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build() -> None:
    from areal_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.build()
    log(f"[build] {_build.sources()} built in {time.monotonic() - t0:.1f}s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def _kernel_inputs(kv: str, seed: int = 0):
    """Stacked cache + ragged page tables at the slice's shapes."""
    from areal_tpu_torch.inference import paged_kv

    g = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    L, KH, H, hd, psz, S, wp = 28, 2, 12, 128, 128, 32, 16
    N = S * wp + 1
    lengths = np.concatenate(
        [[1, psz - 1, psz, psz + 1, wp * psz, wp * psz - 1], rng.integers(1, wp * psz + 1, S - 6)]
    ).astype(np.int32)
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    pt = np.zeros((S, wp), np.int32)  # unused columns stay on trash page 0
    for s in range(S):
        need = -(-int(lengths[s]) // psz)
        pt[s, :need] = perm[s * wp : s * wp + need]
    # shared pages: slots 7 and 8 alias slot 6's first 3 pages
    pt[7, :3] = pt[6, :3]
    pt[8, :3] = pt[6, :3]
    shape = (L, KH, N, psz, hd)
    q = torch.randn((S, H, hd), generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)
    v = torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)
    scales = {}
    if kv != "bf16":
        qd = paged_kv.quant_dtype(kv)
        k, ks = paged_kv.quantize_kv(k, qd)
        v, vs = paged_kv.quantize_kv(v, qd)
        scales = dict(k_scales=ks, v_scales=vs)
    return (
        q,
        k,
        v,
        torch.from_numpy(lengths).cuda(),
        torch.from_numpy(pt).cuda(),
        scales,
    )


def _bound(kv: str, lengths: np.ndarray, S: int, H: int, KH: int, hd: int, psz: int, wp: int):
    """Least time for the work these inputs need: each input byte read once
    (only the rows below each length), each output written once; ops are
    2 flops per multiply-add of q.k and p.v at the tensor-core rate."""
    rows = np.minimum(lengths.astype(np.int64), wp * psz)
    elem = 2 if kv == "bf16" else 1
    kv_bytes = int(rows.sum()) * KH * hd * 2 * elem
    if kv != "bf16":
        kv_bytes += int(rows.sum()) * KH * 2 * 4  # narrow f32 scales
    pt_bytes = int(np.ceil(rows / psz).sum()) * 4
    qo_bytes = 2 * S * H * hd * 2 + S * 4
    nbytes = kv_bytes + pt_bytes + qo_bytes
    ops = 4 * int(rows.sum()) * H * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kv] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel() -> dict:
    from areal_tpu_torch.ops.paged_attention import paged_attention_plain, paged_attention_stacked

    li = 5
    per: dict[str, dict] = {}
    for kv in ("bf16", "int8", "fp8"):
        q, k, v, lengths, pt, sc = _kernel_inputs(kv)
        ks, vs = sc.get("k_scales"), sc.get("v_scales")
        S, H, hd = q.shape
        KH, psz, wp = k.shape[1], k.shape[3], pt.shape[1]
        with torch.no_grad():
            out = paged_attention_stacked(q, k, v, li, lengths, pt, **sc)
            torch.cuda.synchronize()
            ref = paged_attention_plain(
                q, k[li], v[li], lengths, pt,
                ks[li] if ks is not None else None, vs[li] if vs is not None else None,
            )
            err = (out.float() - ref.float()).abs().max().item()
            if not math.isfinite(err) or err > KERNEL_TOL:
                raise AssertionError(f"[kernel] {kv}: max|kernel - plain| = {err} > {KERNEL_TOL}")
            # timed launches cycle over all 28 layers, so each call finds its
            # pages cold in the 50 MB L2 as a decode step does
            nl = k.shape[0]
            it = iter(range(10**9))
            ms = time_cuda(
                lambda: paged_attention_stacked(q, k, v, next(it) % nl, lengths, pt, **sc), iters=56
            )

            def plain_call():
                j = next(it) % nl
                return paged_attention_plain(
                    q, k[j], v[j], lengths, pt,
                    ks[j] if ks is not None else None, vs[j] if vs is not None else None,
                )

            plain_ms = time_cuda(plain_call, iters=10)
            # yardstick: one SDPA call over the window already gathered
            # (and dequantized) — the port never calls it
            W = wp * psz
            ptl = pt.long()

            def gathered(pages, scales, j):
                gth = pages[j][:, ptl].reshape(KH, S, W, hd).permute(1, 0, 2, 3)
                if scales is None:
                    return gth.contiguous()
                s_ = scales[j][:, ptl].reshape(KH, S, W, 1).permute(1, 0, 2, 3)
                return (gth.float() * (s_ / 127.5)).to(torch.bfloat16).contiguous()

            # 4 layers' windows (> 50 MB together), cycled like the kernel's
            kvg = [(gathered(k, ks, j), gathered(v, vs, j)) for j in range(4)]
            mask = (torch.arange(W, device="cuda")[None, :] < lengths[:, None].long())[:, None, None, :]
            qs = q[:, :, None, :]

            def sdpa_call():
                kg, vg = kvg[next(it) % 4]
                return torch.nn.functional.scaled_dot_product_attention(
                    qs, kg, vg, attn_mask=mask, enable_gqa=True
                )

            lib_ms = time_cuda(sdpa_call)
            del kvg
            if kv == "bf16":
                # uniform lengths: per-step slope vs the floor of a launch
                for n in (128, 512, 2048):
                    un = torch.full_like(lengths, n)
                    t = time_cuda(
                        lambda: paged_attention_stacked(q, k, v, next(it) % nl, un, pt), iters=56
                    )
                    log(f"[kernel] bf16 pages, every slot at {n} rows: kernel={t:.4f} ms "
                        f"bound={_bound(kv, un.cpu().numpy(), S, H, KH, hd, psz, wp)[0]:.4f} ms")
        bound_ms, bound_by = _bound(kv, lengths.cpu().numpy(), S, H, KH, hd, psz, wp)
        per[kv] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
        log(
            f"[kernel] {kv} pages: max_abs_err={err:.3e} (tol {KERNEL_TOL}) "
            f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms sdpa={lib_ms:.4f} ms "
            f"bound={bound_ms:.4f} ms ({bound_by}) sum(len)={int(lengths.sum())}"
        )
        del q, k, v, sc, ks, vs, out, ref
        torch.cuda.empty_cache()
    return per


def _post(addr: str, path: str, body: dict, timeout: float = 900.0) -> dict:
    req = urllib.request.Request(
        f"http://{addr}{path}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _wave(addr: str, bodies: list[dict]) -> list[dict]:
    out: list = [None] * len(bodies)
    errs: list = []

    def run(i):
        try:
            out[i] = _post(addr, "/generate", bodies[i])
        except Exception as e:  # noqa: BLE001 — collected and raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=1200)
    if errs or any(o is None for o in out):
        raise RuntimeError(f"/generate failed: {errs[:2]}")
    return out


def _check_response(r: dict, n_new: int, what: str) -> None:
    lp = r["output_logprobs"]
    if len(r["output_tokens"]) != n_new or len(lp) != n_new or len(r["output_versions"]) != n_new:
        raise AssertionError(f"[{what}] incomplete response: {len(r['output_tokens'])}/{n_new}")
    if not all(math.isfinite(x) and x <= 0.0 for x in lp):
        raise AssertionError(f"[{what}] logprobs not finite and <= 0: {lp[:4]}")


def _dense_check(model, prompt: list[int], r: dict, greedy: bool) -> float:
    """Teacher-forced dense prefill over prompt + output. Sampled responses:
    max |served logprob - dense log-softmax|. Greedy responses (their
    logprob is ~0 under the temperature-0 distribution): max shortfall of
    each chosen token's dense logit below the dense argmax."""
    from areal_tpu_torch.models import qwen

    out = r["output_tokens"]
    ids = torch.tensor([prompt + out], device="cuda")
    with torch.no_grad():
        h, _, _ = qwen.forward_prefill(model, ids, torch.arange(ids.shape[1], device="cuda")[None])
        logits = qwen.compute_logits(model, h[0, len(prompt) - 1 : len(prompt) - 1 + len(out)])
    tok = torch.tensor(out, device="cuda")[:, None]
    if greedy:
        return (logits.max(dim=-1).values - logits.gather(1, tok)[:, 0]).max().item()
    dense = torch.log_softmax(logits, dim=-1).gather(1, tok)[:, 0]
    return (dense - torch.tensor(r["output_logprobs"], device="cuda")).abs().max().item()


def _profile_wave(addr: str, bodies: list[dict], card: str) -> None:
    """One more wave of the same requests under torch.profiler: the share
    of the wave's wall time in which the card ran any kernel or copy, and
    the kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _wave(addr, bodies)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    log(f"[profile] {card}: device busy {busy / wall_us:.1%} of a {wall_us / 1e6:.2f} s wave "
        f"({len(spans)} device ops); idle {1 - busy / wall_us:.1%}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[profile]   {us / 1e3:9.2f} ms  {us / busy:6.1%} of busy  {name[:90]}")


def phase_serve(card: str) -> tuple[int, dict]:
    from areal_tpu_torch.api.config import ServerConfig
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.inference.server import ServerThread
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked

    mcfg = qwen.ModelConfig(**QWEN25_15B)
    t0 = time.monotonic()
    model = qwen.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"[serve] Qwen2.5-1.5B random weights (seed 0) in {time.monotonic() - t0:.1f}s")
    cfg = ServerConfig(
        max_batch_size=32,
        max_seq_len=2048,
        page_size=128,
        decode_steps_per_call=16,
        enable_prefix_caching=False,
        host="127.0.0.1",
        seed=0,
    )
    engine = DecodeEngine(cfg, params=model)
    srv = ServerThread(cfg, engine=engine)
    srv.start()
    try:
        rng = np.random.default_rng(0)
        n_new = 128
        prompts = [
            rng.integers(0, mcfg.vocab_size, int(n)).tolist() for n in rng.integers(64, 513, 16)
        ]

        def body(p, i):
            sp = {"max_new_tokens": n_new, "greedy": True} if i % 2 == 0 else {
                "max_new_tokens": n_new, "temperature": 1.0}
            return {"input_ids": p, "sampling_params": sp}

        # main path: counts to 0 just before, read just after
        paged_attention_stacked.launches = 0
        steps0 = engine.stats["decode_steps"]
        t0 = time.monotonic()
        resps = _wave(srv.address, [body(p, i) for i, p in enumerate(prompts)])
        wall = time.monotonic() - t0
        launches = paged_attention_stacked.launches
        steps = engine.stats["decode_steps"] - steps0
        for r in resps:
            _check_response(r, n_new, "serve")
        if launches != mcfg.num_layers * steps or steps == 0:
            raise AssertionError(
                f"[serve] kernel launches {launches} != layers {mcfg.num_layers} x steps {steps}"
            )
        log(f"[serve] 16/16 responses complete; kernel launches {launches} = "
            f"{mcfg.num_layers} layers x {steps} decode steps")
        dev = engine.device_seconds()
        toks = sum(len(r["output_tokens"]) for r in resps)
        log(
            f"[serve] {card}: decode {toks / wall:.1f} tok/s end to end ({toks} tokens, "
            f"{wall:.2f} s wall incl. prefill); {dev['decode_s'] / dev['decode_steps'] * 1e3:.2f} "
            f"ms per decode step (device stream, S=32 slots, 16 active); prefill "
            f"{dev['prefill_tokens'] / dev['prefill_s']:.0f} tok/s (device stream, "
            f"{dev['prefill_tokens']} tokens)"
        )
        metrics = dict(
            decode_tok_s=toks / wall,
            ms_per_step=dev["decode_s"] / dev["decode_steps"] * 1e3,
            wall_ms_per_step=wall / steps * 1e3,
            prefill_tok_s=dev["prefill_tokens"] / dev["prefill_s"],
        )
        errs = [_dense_check(model, prompts[i], resps[i], greedy=False) for i in (1, 3)]
        gaps = [_dense_check(model, prompts[i], resps[i], greedy=True) for i in (0, 2)]
        log(f"[serve] sampled logprobs vs dense prefill: max|diff| {max(errs):.4f} "
            f"(tol {LOGPROB_TOL}); greedy tokens' dense-logit gap to argmax "
            f"{max(gaps):.4f} (tol {LOGPROB_TOL})")
        if max(errs) > LOGPROB_TOL or max(gaps) > LOGPROB_TOL:
            raise AssertionError("[serve] served output disagrees with the dense prefill")

        # second wave: a weight update lands while sequences are in flight
        model2 = qwen.init_params(mcfg, torch.Generator(device="cuda").manual_seed(1))
        wave2: list = []
        th = threading.Thread(
            target=lambda: wave2.extend(
                _wave(srv.address, [body(p, 1) for p in prompts[:8]])
            )
        )
        gen0 = engine.stats["generated_tokens"]
        th.start()
        deadline = time.monotonic() + 300
        while engine.stats["generated_tokens"] - gen0 < 8 * 16 and time.monotonic() < deadline:
            time.sleep(0.01)
        engine.update_weights_from_params(model2, version=1)
        th.join(timeout=900)
        if len(wave2) != 8:
            raise AssertionError("[serve] second wave incomplete")
        split = 0
        for r in wave2:
            _check_response(r, n_new, "serve")
            vers = r["output_versions"]
            if vers != sorted(vers) or set(vers) - {0, 1}:
                raise AssertionError(f"[serve] version tags not 0..0,1..1: {vers}")
            split += 0 in vers and 1 in vers
        if not split:
            raise AssertionError("[serve] no in-flight sequence spans the update")
        log(f"[serve] weight update v0->v1 mid-generation: {split}/8 sequences carry 0..0,1..1")
        del model2
        _profile_wave(srv.address, [body(p, i) for i, p in enumerate(prompts)], card)
    finally:
        srv.stop()
    return launches, metrics


def phase_serve_int8() -> int:
    from areal_tpu_torch.api.config import ServerConfig
    from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked

    mcfg = qwen.ModelConfig(**QWEN25_15B)
    model = qwen.init_params(mcfg, torch.Generator(device="cuda").manual_seed(2))
    cfg = ServerConfig(
        max_batch_size=8,
        max_seq_len=1024,
        page_size=128,
        decode_steps_per_call=16,
        enable_prefix_caching=False,
        kv_quantization="int8",
        seed=0,
    )
    engine = DecodeEngine(cfg, params=model)
    engine.start()
    try:
        rng = np.random.default_rng(1)
        paged_attention_stacked.launches = 0
        steps0 = engine.stats["decode_steps"]
        done = threading.Semaphore(0)
        resps: list = []

        def cb(r):
            resps.append(r)
            done.release()

        for n in rng.integers(64, 513, 8):
            engine.submit(
                ModelRequest(
                    input_ids=rng.integers(0, mcfg.vocab_size, int(n)).tolist(),
                    gconfig=GenerationHyperparameters(max_new_tokens=32, temperature=1.0),
                ),
                cb,
            )
        for _ in range(8):
            if not done.acquire(timeout=600):
                raise AssertionError("[serve_int8] timed out")
        launches = paged_attention_stacked.launches
        steps = engine.stats["decode_steps"] - steps0
    finally:
        engine.stop()
    for r in resps:
        _check_response(
            {"output_tokens": r.output_tokens, "output_logprobs": r.output_logprobs,
             "output_versions": r.output_versions}, 32, "serve_int8")
    if launches != mcfg.num_layers * steps or steps == 0:
        raise AssertionError(f"[serve_int8] launches {launches} != {mcfg.num_layers} x {steps}")
    log(f"[serve_int8] 8/8 responses complete on int8 KV pages; scaled kernel launches "
        f"{launches} = {mcfg.num_layers} x {steps} steps")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import areal_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the areal_tpu_torch package is not importable: {e}", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.monotonic()
    phase_build()
    per = phase_kernel()
    launches, _ = phase_serve(card)
    torch.cuda.empty_cache()
    phase_serve_int8()
    b = per["bf16"]
    kernels = [
        {
            "name": "paged_attention_stacked",
            "route": "cuda",
            "source": "areal_tpu_torch/csrc/paged_attention.cu",
            "replaces": "areal_tpu/ops/paged_attention_q8.py:274",
            "launches": launches,
            "max_abs_err": max(p["max_abs_err"] for p in per.values()),
            "ms": b["ms"],
            "plain_ms": b["plain_ms"],
            "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"],
            "library_ms": b["library_ms"],
        }
    ]
    log(f"[done] all phases passed in {time.monotonic() - t0:.1f}s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
