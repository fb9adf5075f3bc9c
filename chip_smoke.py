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
4. kernel_flash — the flash-attention kernels K2 (forward), K3 (dK, dV)
              and K4 (dQ) against their plain PyTorch versions at the
              trainer's shapes (packed [G, 1024] grids of the train phase's
              sequences, H=12 with KV repeated from 2, hd=128, bf16, padded
              tail); kernel / plain / SDPA-yardstick times and the bounds.
5. serve    — an ``InferenceServer`` over Qwen2.5-1.5B (full width and
              depth, random bf16 weights from a seed) answers 16 concurrent
              /generate requests; checks completeness, logprobs against a
              dense prefill, the kernel's launch count, and the version
              tags across a mid-generation weight update.
6. serve_int8 — a short second engine with int8 KV pages.
7. train    — two asynchronous-GRPO steps at full width and depth: the
              ``DecodeEngine`` generates 8 prompts x 4 samples, the
              ``TorchTrainEngine`` recomputes proximal logprobs (K2),
              ``PPOActor`` computes advantages and runs ``ppo_update`` (two
              minibatches: K2 + K3 + K4 under per-layer checkpointing, then
              AdamW), ``update_weights`` pushes the weights into the running
              engine, and the next wave carries version 1. Checks the
              logprobs on both waves, finite loss and grad norm (and the
              plain attention's grad norm on one minibatch), moved weights,
              version tags and every kernel's launch count.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Needs one card; builds into
``areal_tpu_torch/_build/``; no network.
"""

from __future__ import annotations

import dataclasses
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
# that is ~1e-2 per logit, held with a margin of 10. The same bound holds the
# trainer's recomputed logprobs (flash kernels, logits rounded to bf16 as the
# JAX trainer rounds them) against the served ones.
LOGPROB_TOL = 0.1
# flash kernels vs their plain versions on the same bf16 inputs, element by
# element on valid rows: |kernel - plain| <= FLASH_RTOL |plain| + FLASH_ATOL
# rms(plain). The plain versions keep S, dP and every sum in f32 (the
# backward's also rounds P and dS to bf16 where the kernels feed the tensor
# cores), so what remains is the kernels' bf16 output rounding (2^-8
# relative) and their f32 summation order: FLASH_RTOL is two bf16 steps, and
# FLASH_ATOL, for entries whose sums cancel to near zero, sits between the
# kernels' need (~1e-2 rms) and that of a planted fault such as S or dP
# rounded to bf16 (~1e-1 rms); _flash_check fails if a planted fault passes
FLASH_RTOL = 2**-7
FLASH_ATOL = 2**-5
# grad norm with the plain attention vs the kernels on one minibatch, the
# proximal logprobs recomputed at the current weights (PPO ratio ~1, so no
# token sits at the clip boundary): the two round to bf16 at different
# points in every layer's forward, recompute and backward, which moved the
# norm by 0.16% (PR 2's run); six times that
GRAD_NORM_RTOL = 1e-2


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


def _train_sequences(seed: int = 0) -> list[int]:
    """Lengths of the train phase's 32 sequences: prompts of 64-512 tokens
    drawn from ``seed`` (8 prompts, 4 samples each) plus 128 new tokens."""
    rng = np.random.default_rng(seed)
    return [int(n) + 128 for n in rng.integers(64, 513, 8) for _ in range(4)]


def _flash_inputs(seed: int = 0):
    """The packed grid the trainer builds for one wave (FFD rows of L=1024,
    per-row segment ids, padded tails) and bf16 q/k/v/dO [G, L, 12, 128]
    with K/V repeated from 2 heads, dO zero on padding rows."""
    from areal_tpu_torch.utils.grid import pack_grid

    lens = _train_sequences(seed)
    mask = np.zeros((len(lens), max(lens)), bool)
    for i, n in enumerate(lens):
        mask[i, :n] = True
    grid = pack_grid({"attention_mask": mask}, 1024)
    seg = torch.from_numpy(grid.data["segment_ids"]).cuda()
    G, L = seg.shape
    H, KH, hd = 12, 2, 128
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((G, L, H, hd), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (
        torch.randn((G, L, KH, hd), generator=g, device="cuda")
        .to(torch.bfloat16)
        .repeat_interleave(H // KH, dim=2)
        for _ in range(2)
    )
    dout = torch.randn((G, L, H, hd), generator=g, device="cuda").to(torch.bfloat16)
    dout = dout * (seg != 0)[:, :, None, None]
    return q, k, v, dout, seg, grid.seq_lens


def _flash_bounds(G: int, L: int, H: int, hd: int, seq_lens) -> dict:
    """Least time of each kernel's work on these inputs. Operations: the
    causal pairs of every segment, sum n(n+1)/2, times 2 flops per
    multiply-add per head-dim element per product: forward 2 products (q.k,
    p.v); K3 4 (recomputed q.k and do.v, then dV, dK); K4 3 (q.k, do.v,
    dQ). (A fused backward would share the recompute: 5 products, 2.5x the
    forward.) Bytes: each input read once, each output written once."""
    pairs = sum(n * (n + 1) // 2 for n in seq_lens)
    unit = 2 * hd * H * pairs  # flops of one product over the causal pairs
    grid = G * L * H * hd * 2  # one bf16 [G, L, H, hd] tensor
    rows = G * L * H * 4  # one f32 [G, L, H] row statistic
    seg = G * L * 4
    work = {
        "flash_attention_fwd": (2 * unit, 4 * grid + rows + seg),  # q, k, v -> o, lse
        "flash_attention_bwd_dkv": (4 * unit, 6 * grid + 2 * rows + seg),  # q,k,v,do,lse,di -> dk,dv
        "flash_attention_bwd_dq": (3 * unit, 5 * grid + 2 * rows + seg),  # q,k,v,do,lse,di -> dq
    }
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / PEAK_OPS["bf16"] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def _flash_excess(got, ref, valid) -> tuple[float, float]:
    """Worst element over valid rows of |got - ref| as a share of the limit
    FLASH_RTOL |ref| + FLASH_ATOL rms(ref) (the check passes at <= 1), and
    rms(ref)."""
    g, r = got.float()[valid], ref.float()[valid]
    rms = r.pow(2).mean().sqrt()
    return ((g - r).abs() / (FLASH_RTOL * r.abs() + FLASH_ATOL * rms)).max().item(), rms.item()


def _flash_check(grads, refs, valid) -> dict[str, tuple[float, float, float]]:
    """Hold K3/K4's dq, dk, dv to the limit; returns each one's (share of
    the limit, rms of the reference, max |diff|)."""
    errs = {}
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        x, rms = _flash_excess(got, ref, valid)
        e = (got.float() - ref.float())[valid].abs().max().item()
        if not x <= 1.0:
            raise AssertionError(f"[kernel_flash] {name}: off its plain version by {x:.3f} x the limit "
                                 f"(rms {rms:.4f}, max|diff| {e:.3e})")
        errs[name] = (x, rms, e)
    return errs


def _bwd_bf16_products(q, k, v, seg, dout, lse, di):
    """A planted fault for the K3/K4 check: the plain backward with S and dP
    rounded to bf16, as a kernel that kept them in bf16 would have them."""
    from areal_tpu_torch.ops import attention as fa

    q, k, v, dout = (x.float() for x in (q, k, v, dout))
    scale = q.shape[-1] ** -0.5
    mask = fa.attention_mask(seg)
    s = (torch.einsum("gqhd,gkhd->ghqk", q, k) * scale).bfloat16().float()
    p = torch.where(mask, torch.exp(s - lse.transpose(1, 2)[..., None]), 0.0)
    dp = torch.einsum("gqhd,gkhd->ghqk", dout, v).bfloat16().float()
    ds = p * (dp - di.transpose(1, 2)[..., None])
    p, ds = p.bfloat16().float(), ds.bfloat16().float()
    return (
        torch.einsum("ghqk,gkhd->gqhd", ds, k) * scale,
        torch.einsum("ghqk,gqhd->gkhd", ds, q) * scale,
        torch.einsum("ghqk,gqhd->gkhd", p, dout),
    )


def phase_kernel_flash() -> dict:
    from areal_tpu_torch.ops import attention as fa

    q, k, v, dout, seg, seq_lens = _flash_inputs()
    G, L, H, hd = q.shape
    valid = seg != 0
    per: dict[str, dict] = {}
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v, seg, with_lse=True)
        di = (dout.float() * out.float()).sum(-1)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, seg, dout, lse, di)
        dq = fa.flash_attention_bwd_dq(q, k, v, seg, dout, lse, di)
        ref_out, ref_lse = fa.flash_attention_fwd_plain(*(x.float() for x in (q, k, v)), seg)
        torch.cuda.synchronize()
        err_o = (out.float() - ref_out.float())[valid].abs().max().item()
        err_lse = (lse - ref_lse)[valid].abs().max().item()
        pad_zero = torch.count_nonzero(out[~valid]).item() == 0
        if not math.isfinite(err_lse) or err_lse > 1e-3:  # f32 row statistics
            raise AssertionError(f"[kernel_flash] K2: max|lse - plain| = {err_lse}")
        x_o, rms_o = _flash_excess(out, ref_out, valid)
        if not x_o <= 1.0 or not pad_zero:
            raise AssertionError(f"[kernel_flash] K2: O off its plain version by {x_o:.3f} x the limit, "
                                 f"pad rows zero: {pad_zero}")
        del ref_out, ref_lse
        # K3 and K4 from the kernels' lse and di, so they are held alone
        refs = fa.flash_attention_bwd_plain(q, k, v, seg, dout, lse, di, out_dtype=torch.float32)
        errs = _flash_check((dq, dk, dv), refs, valid)
        faults = {
            "S, dP rounded to bf16": _bwd_bf16_products(q, k, v, seg, dout, lse, di),
            "lse stored in bf16": fa.flash_attention_bwd_plain(
                q, k, v, seg, dout, lse.bfloat16().float(), di, out_dtype=torch.float32),
            "di left out": fa.flash_attention_bwd_plain(
                q, k, v, seg, dout, lse, torch.zeros_like(di), out_dtype=torch.float32),
        }
        fault_x = {}
        for fname, grads in faults.items():
            fault_x[fname] = max(_flash_excess(g, r, valid)[0] for g, r in zip(grads, refs))
            if fault_x[fname] <= 1.0:
                raise AssertionError(f"[kernel_flash] the K3/K4 check passes a planted fault ({fname})")
        del faults, refs
        log(f"[kernel_flash] G={G} L={L} H={H} hd={hd}, {len(seq_lens)} segments "
            f"({sum(seq_lens)} tokens, {int((~valid).sum())} pad rows); limit |kernel - plain| <= "
            f"{FLASH_RTOL:.4g} |plain| + {FLASH_ATOL:.4g} rms(plain), worst element as a share of it: "
            f"O {x_o:.3f} (rms {rms_o:.4f}, max|diff| {err_o:.3e}); " + "; ".join(
                f"{n} {x:.3f} (rms {r:.4f}, max|diff| {e:.3e})" for n, (x, r, e) in errs.items())
            + f"; max|lse - plain| {err_lse:.2e} (tol 1e-3)")
        log("[kernel_flash] planted faults in the plain backward, worst element as a share of the "
            "limit (each must exceed 1): " + "; ".join(f"{n} {x:.3f}" for n, x in fault_x.items()))
        t_fwd = time_cuda(lambda: fa.flash_attention_fwd(q, k, v, seg, with_lse=True), iters=20)
        t_fwd_nolse = time_cuda(lambda: fa.flash_attention_fwd(q, k, v, seg, with_lse=False), iters=20)
        t_dkv = time_cuda(lambda: fa.flash_attention_bwd_dkv(q, k, v, seg, dout, lse, di), iters=20)
        t_dq = time_cuda(lambda: fa.flash_attention_bwd_dq(q, k, v, seg, dout, lse, di), iters=20)
        p_fwd = time_cuda(lambda: fa.flash_attention_fwd_plain(q, k, v, seg), iters=3, warmup=1)
        p_bwd = time_cuda(lambda: fa.flash_attention_bwd_plain(q, k, v, seg, dout, lse, di), iters=3, warmup=1)
    # yardstick the port never calls: SDPA with the same boolean mask, on
    # [G, H, L, hd] copies made outside the timed region
    mask = fa.attention_mask(seg)
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, dout))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        lib_fwd = time_cuda(lambda: sdpa(qt, kt, vt, attn_mask=mask), iters=5, warmup=2)
    leaves = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    o_lib = sdpa(*leaves, attn_mask=mask)

    def lib_bwd():
        for x in leaves:
            x.grad = None
        o_lib.backward(dot, retain_graph=True)

    lib_b = time_cuda(lib_bwd, iters=5, warmup=2)
    del o_lib, leaves, qt, kt, vt, dot, mask
    bounds = _flash_bounds(G, L, H, hd, seq_lens)
    per["flash_attention_fwd"] = dict(max_abs_err=err_o, ms=t_fwd, plain_ms=p_fwd, library_ms=lib_fwd)
    per["flash_attention_bwd_dkv"] = dict(max_abs_err=max(errs["dk"][2], errs["dv"][2]), ms=t_dkv, plain_ms=p_bwd, library_ms=lib_b)
    per["flash_attention_bwd_dq"] = dict(max_abs_err=errs["dq"][2], ms=t_dq, plain_ms=p_bwd, library_ms=lib_b)
    for name, d in per.items():
        d["bound_ms"], d["bound_by"] = bounds[name]
        log(f"[kernel_flash] {name}: kernel={d['ms']:.4f} ms plain={d['plain_ms']:.4f} ms "
            f"sdpa={d['library_ms']:.4f} ms bound={d['bound_ms']:.4f} ms ({d['bound_by']})")
    log(f"[kernel_flash] K2 without the logsumexp (the no-grad forward): {t_fwd_nolse:.4f} ms; "
        f"plain backward computes dq, dk and dv in one call ({p_bwd:.4f} ms); SDPA forward "
        f"{lib_fwd:.4f} ms, backward {lib_b:.4f} ms, forward+backward {lib_fwd + lib_b:.4f} ms")
    del q, k, v, dout, out, lse, dk, dv, dq, di
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


def _profile(fn, label: str, card: str) -> None:
    """Run ``fn`` once under torch.profiler: the share of its wall time in
    which the card ran any kernel or copy, and the kernels that took the
    most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
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
    log(f"[profile] {card}: device busy {busy / wall_us:.1%} of a {wall_us / 1e6:.2f} s {label} "
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
        _profile(lambda: _wave(srv.address, [body(p, i) for i, p in enumerate(prompts)]), "wave", card)
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


_SNAP_ROWS = 4096  # embedding rows watched


def _snapshot(model) -> dict[str, torch.Tensor]:
    """Copies of a few master weights (matrices, a bias, norms, the first
    embedding rows) to see them move."""
    sd = dict(model.named_parameters())
    last = model.cfg.num_layers - 1
    names = ["layers.0.wq", "layers.0.bq", f"layers.{last}.w_down", f"layers.{last}.input_norm", "final_norm"]
    snap = {n: sd[n].detach().clone() for n in names}
    snap["embed"] = sd["embed"][:_SNAP_ROWS].detach().clone()
    return snap


def _moved(model, snap: dict[str, torch.Tensor]) -> dict[str, float]:
    sd = dict(model.named_parameters())
    return {n: (sd[n][: len(t)] - t).abs().max().item() for n, t in snap.items()}


def _rollout(engine, prompts: list[list[int]], n_samples: int, n_new: int):
    """One wave: every prompt ``n_samples`` times, temperature 1.0; returns
    the trajectory dicts built as the RLVR workflow builds them, the reward
    being the share of even token ids among the new tokens."""
    from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest

    reqs = [p for p in prompts for _ in range(n_samples)]
    out: list = [None] * len(reqs)
    done = threading.Semaphore(0)

    def cb_for(i):
        def cb(r):
            out[i] = r
            done.release()

        return cb

    for i, p in enumerate(reqs):
        engine.submit(
            ModelRequest(
                input_ids=p,
                gconfig=GenerationHyperparameters(max_new_tokens=n_new, temperature=1.0),
            ),
            cb_for(i),
        )
    for _ in reqs:
        if not done.acquire(timeout=900):
            raise AssertionError("[train] rollout timed out")
    trajs = []
    for p, r in zip(reqs, out):
        if len(r.output_tokens) != n_new:
            raise AssertionError(f"[train] incomplete response {len(r.output_tokens)}/{n_new} ({r.stop_reason})")
        n_p, n_o = len(p), len(r.output_tokens)
        trajs.append({
            "input_ids": np.asarray(p + r.output_tokens, np.int32),
            "loss_mask": np.concatenate([np.zeros(n_p, np.float32), np.ones(n_o, np.float32)]),
            "logprobs": np.concatenate([np.zeros(n_p, np.float32), np.asarray(r.output_logprobs, np.float32)]),
            "versions": np.concatenate([np.full(n_p, -1, np.int32), np.asarray(r.output_versions, np.int32)]),
            "rewards": np.float32(np.mean(np.asarray(r.output_tokens) % 2 == 0)),
            "seq_no_eos_mask": np.bool_(r.stop_reason == "length" or bool(r.truncated_by)),
        })
    return trajs


def _clip_set(outputs: dict, b: dict, cfg) -> torch.Tensor:
    """The tokens PPO's clip cuts out of the gradient (``clip_mask`` of
    ``ppo_actor_loss_fn``), from one grid's outputs and data."""
    lm = (b["loss_mask"] > 0) & b["label_valid"]
    ratio = torch.exp(outputs["logprobs"].detach() - b["prox_logprobs"])
    hi = cfg.eps_clip if cfg.eps_clip_higher is None else cfg.eps_clip_higher
    adv = b["advantages"]
    return (-adv * ratio < -adv * ratio.clamp(1.0 - cfg.eps_clip, 1.0 + hi)) & lm


def _logprob_gap(trainer_logp: np.ndarray, batch: dict) -> float:
    """max |trainer - served| logprob over the generated tokens."""
    gen = np.asarray(batch["loss_mask"]) > 0
    return float(np.abs(trainer_logp[gen] - np.asarray(batch["logprobs"])[gen]).max())


def phase_train(card: str) -> dict:
    from areal_tpu_torch.api.config import (
        NormConfig,
        OptimizerConfig,
        PPOActorConfig,
        ServerConfig,
    )
    from areal_tpu_torch.api.io_struct import FinetuneSpec, WeightUpdateMeta
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.ops import attention as fa
    from areal_tpu_torch.trainer.ppo import PPOActor
    from areal_tpu_torch.utils.data import MicroBatchSpec, pad_sequences_to_tensors, split_padded_tensor_dict_into_mb_list

    group, n_prompts, n_new = 4, 8, 128
    mcfg = qwen.ModelConfig(**QWEN25_15B)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    cfg = PPOActorConfig(
        dtype="bfloat16",
        param_dtype="float32",
        attn_impl="pallas",
        gradient_checkpointing=True,
        optimizer=OptimizerConfig(lr=1e-5),
        group_size=group,
        # group_size must be given here too: NormConfig's own default (1)
        # takes precedence over PPOActorConfig.group_size, and groups of one
        # would zero every advantage
        adv_norm=NormConfig(mean_level="group", std_level="batch", group_size=group),
        use_decoupled_loss=True,
        prox_logp_mode="recompute",
        ppo_n_minibatches=2,
    )
    trainer = TorchTrainEngine(cfg, model_config=mcfg)
    trainer.initialize(FinetuneSpec(total_train_epochs=1, dataset_size=64, train_batch_size=n_prompts), seed=0)
    actor = PPOActor(cfg, trainer)
    engine = DecodeEngine(
        ServerConfig(max_batch_size=32, max_seq_len=1024, page_size=128, decode_steps_per_call=16,
                     enable_prefix_caching=False, seed=0),
        params=trainer.model.state_dict(),
        model_cfg=mcfg,
    )
    engine.start()
    meta = WeightUpdateMeta(type="mem")
    trainer.connect_engine(engine, meta)
    torch.cuda.synchronize()
    log(f"[train] Qwen2.5-1.5B trainer (f32 master weights, AdamW state) and decode engine "
        f"up in {time.monotonic() - t0:.1f}s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, mcfg.vocab_size, int(n)).tolist() for n in rng.integers(64, 513, n_prompts)]

    def wfn(d):
        return float((np.asarray(d["loss_mask"]) > 0).sum())

    # main path: counts to 0 just before, read just after
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)
    for kern in kernels:
        kern.launches = 0
    parts = {"rollout": 0.0, "prox_recompute": 0.0, "ppo_update": 0.0, "weight_update": 0.0}
    n_fwd_grids = n_mbs = 0
    trained_tokens = 0
    stats_all = []
    gaps = []
    snap0 = None
    adv = None
    try:
        for step in range(2):
            tb = time.monotonic()
            batch = pad_sequences_to_tensors(_rollout(engine, prompts, group, n_new))
            parts["rollout"] += time.monotonic() - tb
            vers = np.asarray(batch["versions"])[np.asarray(batch["loss_mask"]) > 0]
            if not (vers == step).all():
                raise AssertionError(f"[train] wave {step}: token versions {sorted(set(vers.tolist()))} != {{{step}}}")
            tb = time.monotonic()
            batch["prox_logp"] = actor.compute_logp(batch)
            torch.cuda.synchronize()
            parts["prox_recompute"] += time.monotonic() - tb
            n_fwd_grids += len(trainer._make_grids(batch))
            gaps.append(_logprob_gap(batch["prox_logp"], batch))
            log(f"[train] wave {step}: {len(vers)} generated tokens, all at version {step}; trainer's "
                f"recomputed logprobs vs served: max|diff| {gaps[-1]:.4f} (tol {LOGPROB_TOL})")
            if not gaps[-1] <= LOGPROB_TOL:
                raise AssertionError(f"[train] wave {step}: trainer and server disagree on the policy")
            adv = actor.compute_advantages(batch)
            if snap0 is None:
                snap0 = _snapshot(trainer.model)
            tb = time.monotonic()
            stats = actor.ppo_update(adv)
            torch.cuda.synchronize()
            parts["ppo_update"] += time.monotonic() - tb
            trained_tokens += int(np.asarray(batch["attention_mask"]).sum())
            n_mbs += int(sum(s["n_microbatches"] for s in stats))
            stats_all.extend(stats)
            for i, s in enumerate(stats):
                log(f"[train] step {step} minibatch {i}: loss {s['loss']:.6f} grad_norm {s['grad_norm']:.4f} "
                    f"lr {s['lr']:.2e} actor_loss {s['actor_loss']:.6f} behave_imp_weight "
                    f"{s['behave_imp_weight']:.4f} clip_ratio {s['clip_ratio']:.4f} tokens {s['n_valid_tokens']:.0f}")
                if not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]) and s["grad_norm"] > 0):
                    raise AssertionError(f"[train] loss / grad_norm not finite and positive: {s}")
            if step == 0:
                if stats[0]["lr"] != 0.0:
                    raise AssertionError("[train] the first optimizer step must have LR 0")
                moved = _moved(trainer.model, snap0)
                if not all(m > 0 for m in moved.values()):
                    raise AssertionError(f"[train] master weights did not move after the second step: {moved}")
                log("[train] master weights moved after the second optimizer step (the first has LR 0): "
                    + ", ".join(f"{n} {m:.2e}" for n, m in moved.items()))
                tb = time.monotonic()
                trainer.update_weights(meta)
                trainer.set_version(trainer.get_version() + 1)
                torch.cuda.synchronize()
                parts["weight_update"] += time.monotonic() - tb
                if engine.get_version() != 1 or trainer.get_version() != 1:
                    raise AssertionError("[train] versions after the update are not 1")
        counts = [kern.launches for kern in kernels]
    finally:
        engine.stop()
    L = mcfg.num_layers
    want = [L * n_fwd_grids + 2 * L * n_mbs, L * n_mbs, L * n_mbs]
    log(f"[train] launches: K2 {counts[0]} (= {L} x {n_fwd_grids} forward grids + {2 * L} x {n_mbs} "
        f"microbatches, forward and its recompute), K3 {counts[1]}, K4 {counts[2]} (= {L} x {n_mbs})")
    if counts != want:
        raise AssertionError(f"[train] launch counts {counts} != {want}")

    # one more optimizer step on a minibatch of the last batch, profiled
    mb = split_padded_tensor_dict_into_mb_list(adv, MicroBatchSpec(n_mbs=cfg.ppo_n_minibatches)).mbs[0]
    _profile(lambda: trainer.train_batch(mb, actor._loss_fn, wfn), "optimizer step (one minibatch)", card)
    compute_cfg = trainer.model_cfg

    def by_impl(mb):
        """grad norm, clip_ratio and the clipped tokens of one minibatch
        with the kernels and with the plain attention"""
        res = {}
        for impl in ("pallas", "xla"):
            trainer.model_cfg = dataclasses.replace(compute_cfg, attn_impl=impl)
            trainer.zero_grad()
            clipped = []

            def loss_fn(outputs, b):
                clipped.append(_clip_set(outputs, b, cfg).flatten())
                return actor._loss_fn(outputs, b)

            st = trainer.compute_grads(mb, loss_fn, wfn)
            res[impl] = (st["grad_norm"], st["clip_ratio"], torch.cat(clipped))
        trainer.model_cfg = compute_cfg
        trainer.zero_grad()
        rel = abs(res["xla"][0] - res["pallas"][0]) / res["pallas"][0]
        flips = int((res["xla"][2] ^ res["pallas"][2]).sum())
        return res, rel, flips

    def norms_line(res, rel, flips) -> str:
        (n_k, c_k, _), (n_p, c_p, _) = res["pallas"], res["xla"]
        return (f"kernels {n_k:.5f} (clip_ratio {c_k:.4f}), plain attention {n_p:.5f} (clip_ratio "
                f"{c_p:.4f}), relative diff {rel:.2e}; {flips} tokens clipped under one and not the other")

    # the same comparison three optimizer steps past the proximal logprobs,
    # where PPO's clip cuts tokens out of the gradient: a token near the
    # clip boundary falls on either side with the two attentions' rounding
    # (a reading, not a check)
    log("[train] grad_norm on one minibatch, proximal logprobs 3 steps old: " + norms_line(*by_impl(mb)))
    # the check: proximal logprobs recomputed at the current weights, so the
    # ratio is ~1 and no token sits at the clip boundary
    batch["prox_logp"] = actor.compute_logp(batch)
    adv = actor.compute_advantages(batch)
    mb = split_padded_tensor_dict_into_mb_list(adv, MicroBatchSpec(n_mbs=cfg.ppo_n_minibatches)).mbs[0]
    res, rel, flips = by_impl(mb)
    norms = {impl: r[0] for impl, r in res.items()}
    log(f"[train] grad_norm on one minibatch, proximal logprobs recomputed: {norms_line(res, rel, flips)} "
        f"(tol {GRAD_NORM_RTOL})")
    if not rel <= GRAD_NORM_RTOL:
        raise AssertionError("[train] kernel and plain attention gradients disagree")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train] {card}: rollout {parts['rollout']:.2f} s (2 waves x {n_prompts * group} x {n_new} tokens), "
        f"proximal recompute {parts['prox_recompute']:.2f} s, ppo_update {parts['ppo_update']:.2f} s "
        f"({len(stats_all)} optimizer steps), weight update {parts['weight_update']:.3f} s; trainer "
        f"{trained_tokens / parts['ppo_update']:.0f} tokens/s ({trained_tokens} tokens); peak "
        f"torch.cuda.max_memory_allocated {peak:.2f} GiB")
    del trainer, actor, engine
    torch.cuda.empty_cache()
    return dict(counts=dict(zip(("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"), counts)),
                parts=parts, tokens_per_s=trained_tokens / parts["ppo_update"], peak_gib=peak, gaps=gaps, norms=norms)


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
    flash = phase_kernel_flash()
    launches, _ = phase_serve(card)
    torch.cuda.empty_cache()
    phase_serve_int8()
    torch.cuda.empty_cache()
    train = phase_train(card)
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
    replaces = {
        "flash_attention_fwd": "areal_tpu/ops/attention.py:196",
        "flash_attention_bwd_dkv": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        "flash_attention_bwd_dq": "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
    }
    for name, d in flash.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "areal_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces[name],
            "launches": train["counts"][name],
            "max_abs_err": d["max_abs_err"],
            "ms": d["ms"],
            "plain_ms": d["plain_ms"],
            "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"],
            "library_ms": d["library_ms"],
        })
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
