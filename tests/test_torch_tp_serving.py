"""Serving on a ``model=2`` mesh, the port against the JAX package.

JAX's ``DecodeEngine`` serves a ``MeshConfig(model=2)`` CPU mesh from one
process (GSPMD); the port's lead spawns one follower process and the two
ranks join a gloo group of their own (``parallel/serving_group.py``). Both
hold ``TINY_QWEN2`` (4 heads, 2 KV heads) in f32 from the same seeded numpy
weights, and both are driven inline (admission, one chunk or speculative
round, drain; no loop thread), so a weight commit or an abort lands at the
same token on each. Greedy tokens must be equal and logprobs within
``LOGPROB_ATOL``, cold, through the radix cache's warm prefill, through
tree-speculative rounds, across a staged update (the version tags too),
with int8 weights on int8 pages, and across a park and resume; the pools'
page counts must agree. Each rank's served leaves must be JAX's shards of
the same leaves, by ``param_partition_specs`` / ``quant_partition_specs``.
"""

import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.config import MeshConfig as JMeshConfig
from areal_tpu.api.config import ServerConfig as JServerConfig
from areal_tpu.api.config import SpeculativeConfig as JSpec
from areal_tpu.inference import decode_engine as jde
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu_torch.api.config import MeshConfig, ServerConfig, SpeculativeConfig
from areal_tpu_torch.inference import decode_engine as tde
from areal_tpu_torch.models import convert
from areal_tpu_torch.models import qwen as tq

from test_torch_kv_parking import abort_pause, request
from test_torch_qwen import jax_params, port_cfg, port_model
from tpu_testing import TINY_QWEN2

PSZ = 16
LOGPROB_ATOL = 1e-5  # f32 on both sides
SERVER_KW = dict(max_batch_size=4, max_seq_len=256, page_size=PSZ, decode_steps_per_call=4, seed=0)
# periodic prompts (the n-gram drafter's hits) and a random one
PROMPTS = [[7, 3, 9] * 6, list(range(50, 63)), ([5, 11, 5, 11, 2] * 6)[:27], [31, 4, 18, 2, 77]]
N_NEW = 20


def jax_tp_engine(weights, **kw):
    spec = kw.pop("speculative", None)
    cfg = JServerConfig(**{**SERVER_KW, **kw}, mesh=JMeshConfig(data=-1, model=2))
    if spec is not None:
        cfg.speculative = JSpec(**spec)
    eng = jde.DecodeEngine(cfg, params=jax.tree.map(jnp.asarray, weights), model_cfg=TINY_QWEN2,
                           mesh=mesh_lib.make_mesh(cfg.mesh, devices=jax.devices()[:2]))
    eng.initialize()
    return eng


def port_tp_engine(weights, **kw):
    spec = kw.pop("speculative", None)
    cfg = ServerConfig(**{**SERVER_KW, **kw}, mesh=MeshConfig(model=2))
    if spec is not None:
        cfg.speculative = SpeculativeConfig(**spec)
    eng = tde.DecodeEngine(cfg, params=port_model(TINY_QWEN2, weights), device="cpu")
    eng.initialize()
    return eng


def run(eng, reqs, spec: bool = False, stop_after: int | None = None):
    """Submit ``reqs`` together and run admission + one chunk (or one
    speculative round) + drain until every slot is free, or ``stop_after``
    passes; returns the responses by index (None while running)."""
    out = [None] * len(reqs)
    for i, r in enumerate(reqs):
        eng.submit(r, lambda resp, i=i: out.__setitem__(i, resp))
    resume(eng, spec, stop_after)
    return out


def resume(eng, spec: bool = False, stop_after: int | None = None) -> None:
    for n in range(200):
        if stop_after is not None and n == stop_after:
            return
        eng._apply_slot_updates(eng._admit_pending())
        if spec:
            eng._spec_round()
        else:
            eng._drain(eng._dispatch_chunk())
        if not any(t is not None for t in eng._slot_task) and not eng._backlog and eng._queue.empty():
            return
    raise AssertionError("the engine did not drain")


def greedy(side, prompts, rid=""):
    return [request(side, p, rid=f"{rid}{i}" if rid else "", max_new_tokens=N_NEW, greedy=True)
            for i, p in enumerate(prompts)]


def assert_same(jout, tout, versions: bool = False):
    for j, t in zip(jout, tout):
        assert j is not None and t is not None
        assert t.output_tokens == j.output_tokens
        np.testing.assert_allclose(t.output_logprobs, j.output_logprobs, atol=LOGPROB_ATOL)
        assert t.stop_reason == j.stop_reason
        if versions:
            assert t.output_versions == j.output_versions


def assert_pools(jeng, teng):
    assert teng.pool.n_pages == jeng.pool.n_pages
    assert teng.pool.available == jeng.pool.available


@pytest.fixture(scope="module")
def weights():
    return jax_params(TINY_QWEN2, seed=31)


@pytest.fixture(scope="module")
def pair(weights):
    """A JAX and a port engine on model=2, prefix caching on (the default)
    and a tree drafter configured, speculation off until a test turns it
    on."""
    spec = dict(enabled=False, drafter="tree")
    jeng = jax_tp_engine(weights, speculative=spec)
    teng = port_tp_engine(weights, speculative=spec)
    assert teng._group is not None and teng._group.backend == "gloo" and len(teng._group.pids()) == 1
    yield jeng, teng
    pids = teng._group.pids()
    teng.stop()
    assert teng._group.dead() == [(1, teng._group._procs[0].exitcode)] and not _alive(pids)


def _alive(pids) -> list[int]:
    out = []
    for pid in pids:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        # a zombie reaped late still answers: read its state
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().split(")")[-1].split()[0] == "Z":
                    continue
        except OSError:
            continue
        out.append(pid)
    return out


def test_cold_then_warm_prefill_match_jax(pair):
    """A cold wave, then a wave whose prompts share a 3-page prefix with a
    finished request: the port's suffix-only prefill (kernel #3's chain
    launch, on each rank's KV head) and JAX's agree token for token."""
    jeng, teng = pair
    assert_same(run(jeng, greedy("jax", PROMPTS)), run(teng, greedy("port", PROMPTS)))
    assert_pools(jeng, teng)
    shared = np.random.default_rng(5).integers(1, 250, 3 * PSZ + 2).tolist()
    assert_same(run(jeng, greedy("jax", [shared])), run(teng, greedy("port", [shared])))
    warm = [shared[: 3 * PSZ] + [9, 8, 7], shared[: 3 * PSZ] + [1, 2, 3, 4, 5, 6]]
    before = teng.stats["suffix_prefill_batches"]
    assert_same(run(jeng, greedy("jax", warm)), run(teng, greedy("port", warm)))
    assert teng.stats["suffix_prefill_batches"] > before
    assert teng.stats["prefix_hit_tokens"] == jeng.stats["prefix_hit_tokens"] > 0
    assert_pools(jeng, teng)
    assert teng.pool_audit()["ok"]


def test_tree_speculative_rounds_match_jax(pair):
    """Tree-drafted verify rounds (kernel #3's tree launch on each rank)."""
    jeng, teng = pair
    for eng in pair:
        eng.set_speculative(True)
    try:
        jout = run(jeng, greedy("jax", PROMPTS), spec=True)
        tout = run(teng, greedy("port", PROMPTS), spec=True)
    finally:
        for eng in pair:
            eng.set_speculative(False)
    assert_same(jout, tout)
    assert teng.stats["spec_accepted_tokens"] == jeng.stats["spec_accepted_tokens"] > 0
    assert_pools(jeng, teng)


def _jax_flat(w) -> dict[str, np.ndarray]:
    flat = {k: v for k, v in w.items() if k != "layers"}
    flat.update({f"layers/{k}": v for k, v in w["layers"].items()})
    return flat


def test_staged_update_mid_generation_tags_match_jax(pair):
    """Two chunks at version 0, a staged update of whole leaves (two
    buckets) committed as version 1, then the rest: the same tokens, and
    the same per-token version tags."""
    jeng, teng = pair
    new = jax_params(TINY_QWEN2, seed=32)
    jout = run(jeng, greedy("jax", PROMPTS[:2]), stop_after=2)
    tout = run(teng, greedy("port", PROMPTS[:2]), stop_after=2)
    jflat = _jax_flat(new)
    tflat = convert.from_jax_params(new, port_cfg(TINY_QWEN2))
    for eng, flat in ((jeng, jflat), (teng, tflat)):
        eng.begin_staged_update()
        names = sorted(flat)
        eng.stage_weight_bucket({n: flat[n] for n in names[: len(names) // 2]})
        eng.stage_weight_bucket({n: flat[n] for n in names[len(names) // 2 :]})
        assert eng.get_version() == 0
        eng.commit_staged_weights(version=1)
    resume(jeng)
    resume(teng)
    assert_same(jout, tout, versions=True)
    assert {0, 1} <= set(tout[0].output_versions)
    # every rank now serves the pushed leaves' slices
    full = tflat
    specs = tq.param_partition_specs(port_cfg(TINY_QWEN2))
    names = ["embed", "layers.0.wq", "layers.1.wo", "layers.1.bk"]
    for r, got in enumerate(teng.served_slices(names)):
        for n in names:
            assert torch.equal(got[n], tq.tp_slice(full[n], tq.leaf_spec(specs, n), 2, r)), (r, n)


def test_park_and_resume_match_jax(pair):
    """An abort pause parks both decoding requests; the same-rid resubmits
    of prompt + emitted resume on the parked KV with no prefill."""
    jeng, teng = pair
    outs = {}
    for side, eng in (("jax", jeng), ("port", teng)):
        first = run(eng, greedy(side, PROMPTS[1:3], rid="park"), stop_after=2)
        abort_pause(eng)
        eng.continue_generation()
        assert all(r is not None and r.stop_reason == "abort" for r in first)
        again = [request(side, list(p) + list(r.output_tokens), rid=f"park{i}", max_new_tokens=N_NEW - len(
            r.output_tokens), greedy=True) for i, (p, r) in enumerate(zip(PROMPTS[1:3], first))]
        resumes = eng.stats["kv_resumes"]
        outs[side] = (first, run(eng, again), eng.stats["kv_resumes"] - resumes)
    assert_same(outs["jax"][0], outs["port"][0])
    assert_same(outs["jax"][1], outs["port"][1])
    assert outs["port"][2] == outs["jax"][2] == 2
    assert_pools(jeng, teng)


def _model_shard(shard, mesh) -> int:
    """The model-axis coordinate of a JAX shard's device."""
    where = np.argwhere(np.asarray(mesh.devices) == shard.device)[0]
    return int(where[list(mesh.axis_names).index("model")])


def _port_view(name: str, a: np.ndarray) -> np.ndarray:
    """A JAX leaf of one layer in the port's layout: dense [in, out]
    matrices transposed, a scale's [1, out] as [out]."""
    leaf = name.rsplit("/", 1)[-1]
    if leaf.endswith("_scale"):
        return a.reshape(-1)
    return a.T if leaf.removesuffix("_q8") in tq.DENSE_MATRICES else a


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16-specs", "int8-specs"])
def test_served_slices_are_jax_shards(pair, int8_pair, quantized):
    """Every rank's served leaves hold the numbers of JAX's model-axis
    shards of the same leaves (``param_partition_specs``; int8:
    ``quant_partition_specs``, the q8 tables and row scales)."""
    jeng, teng = int8_pair if quantized else pair
    targets = ("wq", "wo", "w_down", "w_up")
    leaves = [f"{t}_q8" for t in targets] + [f"{t}_scale" for t in targets] if quantized else [
        "wq", "wk", "bv", "wo", "w_down"]
    names = ["embed"] + [f"layers.{i}.{leaf}" for i in range(TINY_QWEN2.num_layers) for leaf in leaves]
    served = teng.served_slices(names)
    specs = (tq.quant_partition_specs if quantized else tq.param_partition_specs)(port_cfg(TINY_QWEN2))
    for name in names:
        jname = "embed" if name == "embed" else "layers/" + name.rsplit(".", 1)[-1]
        arr = jeng.params["embed"] if name == "embed" else jeng.params["layers"][jname.split("/")[1]]
        split = tq._axis_dim(tq.leaf_spec(specs, name), "model") is not None
        for shard in arr.addressable_shards:
            r = _model_shard(shard, jeng.mesh)
            data = np.asarray(shard.data)
            if name != "embed":
                data = _port_view(jname, data[int(name.split(".")[1])])
            got = served[r][name].numpy()
            assert got.shape == data.shape, (name, r)
            if name.endswith("_scale"):
                # JAX quantizes under jit, where max|W| / 127 becomes a
                # multiply by 1/127 (ROADMAP Queue C, C-ref 6)
                np.testing.assert_allclose(got, data, rtol=1e-6)
            else:
                np.testing.assert_array_equal(got, data, err_msg=f"{name} rank {r}")
        if not split:
            np.testing.assert_array_equal(served[0][name].numpy(), served[1][name].numpy())


@pytest.fixture(scope="module")
def int8_pair(weights):
    jeng = jax_tp_engine(weights, quantization="int8", kv_quantization="int8")
    teng = port_tp_engine(weights, quantization="int8", kv_quantization="int8")
    yield jeng, teng
    teng.stop()


def test_int8_weights_on_int8_pages_match_jax(int8_pair):
    """int8 weights and int8 KV on the mesh, as
    ``tests/test_quantized_serving.py:189`` serves them."""
    jeng, teng = int8_pair
    assert teng.cache["k"].dtype == torch.int8 and teng.cache["k"].shape[1] == 1  # one KV head a rank
    assert_same(run(jeng, greedy("jax", PROMPTS)), run(teng, greedy("port", PROMPTS)))
    assert_pools(jeng, teng)


def test_refusals_name_their_items(pair):
    """What this slice does not serve on a mesh raises naming its item,
    before any follower starts; nothing carries on at model=1. MoE models
    and the ``expert`` axis serve (``tests/test_torch_moe_mesh.py``); LoRA
    and vision models and LoRA updates are item 6b-2b."""
    jeng, teng = pair
    with pytest.raises(NotImplementedError, match="6b"):  # uneven: 2 KV heads over 4
        tde.DecodeEngine(ServerConfig(**SERVER_KW, mesh=MeshConfig(model=4)),
                         params=port_model(TINY_QWEN2, jax_params(TINY_QWEN2, 1)), device="cpu").initialize()
    mcfg = port_cfg(TINY_QWEN2, lora_rank=4)
    eng = tde.DecodeEngine(ServerConfig(**SERVER_KW, mesh=MeshConfig(model=2)), params={}, model_cfg=mcfg,
                           device="cpu")
    with pytest.raises(NotImplementedError, match="6b-2b"):
        eng.initialize()
    assert eng._group is None
    vlm = port_cfg(TINY_QWEN2, vision=tq.VisionConfig(patch_dim=48, hidden_size=32, intermediate_size=64,
                                                      num_layers=1, num_heads=2, out_hidden_size=64))
    with pytest.raises(NotImplementedError, match="6b-2b"):
        tde.DecodeEngine(ServerConfig(**SERVER_KW, mesh=MeshConfig(model=2)), params={}, model_cfg=vlm,
                         device="cpu").initialize()
    for axis, item in (("fsdp", "item 8"), ("data", "item 8"), ("seq", "6b-3"), ("pipe", "6b-4")):
        with pytest.raises(NotImplementedError, match=item):
            tde.DecodeEngine(ServerConfig(**SERVER_KW, mesh=MeshConfig(**{axis: 2, "model": 2})), device="cpu")
    tde.DecodeEngine(ServerConfig(**SERVER_KW, mesh=MeshConfig(expert=2, model=2)), device="cpu")  # constructs
    with pytest.raises(NotImplementedError, match="6b-2b"):
        teng.update_weights_lora({}, 1.0)


def test_killed_follower_fails_the_loop(weights):
    """A follower killed mid-wave fails the decode loop: the wave's
    requests end, ``is_wedged`` (so ``/health``) reports it, and after
    ``stop`` no follower process is left."""
    eng = port_tp_engine(weights, max_seq_len=512)
    (pid,) = eng._group.pids()
    eng.start()
    got = []
    for i, p in enumerate(PROMPTS):
        eng.submit(request("port", p, max_new_tokens=400, greedy=True, ignore_eos=True), got.append)
    t0 = time.monotonic()
    while eng.stats["chunks"] < 2 and time.monotonic() - t0 < 60:
        time.sleep(0.01)
    os.kill(pid, signal.SIGKILL)
    t0 = time.monotonic()
    while len(got) < len(PROMPTS) and time.monotonic() - t0 < 60:
        time.sleep(0.02)
    assert len(got) == len(PROMPTS) and all(r.stop_reason == "abort" for r in got)
    assert eng._loop_error is not None and eng.is_wedged()
    with pytest.raises(RuntimeError, match="decode loop failed"):
        eng.submit(request("port", PROMPTS[0], max_new_tokens=4), got.append)
    eng.stop()
    assert not _alive([pid])


def test_cli_server_on_a_mesh_drains_and_leaves_no_follower(tmp_path):
    """``python -m areal_tpu_torch.inference.server ... mesh.model=2`` serves
    a tiny HF export on two ranks (``/statusz`` lists both); a SIGTERM
    drains it to its exit code and leaves no follower process."""
    import dataclasses
    import json
    import subprocess
    import sys
    import urllib.request
    from pathlib import Path

    from areal_tpu_torch.models.hf import save_params_to_hf
    from areal_tpu_torch.utils.network import find_free_port
    from test_torch_server_cli import EXIT_CODE, ROOT, _wait_healthy

    mcfg = dataclasses.replace(tq.ModelConfig.from_hf_path(str(ROOT / "examples/smoke/tiny_model")), dtype="float32")
    export = tmp_path / "export"
    save_params_to_hf(tq.init_params(mcfg, torch.Generator().manual_seed(0), device="cpu"), mcfg, str(export))
    port = find_free_port()
    cfg = Path(tmp_path / "server.yaml")
    cfg.write_text(
        "dtype: float32\nmax_batch_size: 4\nmax_seq_len: 64\npage_size: 16\ndecode_steps_per_call: 4\n"
        "host: 127.0.0.1\nseed: 0\n"
        f"preemption:\n  enabled: true\n  grace_s: 20.0\n  drain_budget_s: 2.0\n  exit_code: {EXIT_CODE}\n"
    )
    env = {**os.environ, "AREAL_FLIGHT_DIR": str(tmp_path / "flight"), "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "areal_tpu_torch.inference.server", "--device", "cpu", "--config", str(cfg),
         f"model_path={export}", f"port={port}", "mesh.model=2"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    pids = []
    try:
        addr = f"127.0.0.1:{port}"
        assert _wait_healthy(addr, proc)["status"] == "ok"
        with urllib.request.urlopen(f"http://{addr}/statusz", timeout=30) as r:
            mesh = json.loads(r.read())["mesh"]
        assert mesh["model"] == 2 and len(mesh["ranks"]) == 2
        pids = [r["pid"] for r in mesh["ranks"][1:]]
        # every rank serves its slices of the export, by /debug/weights
        names = ["embed", "layers.0.wq", "layers.1.wo"]
        with urllib.request.urlopen(f"http://{addr}/debug/weights?names={','.join(names)}", timeout=30) as r:
            digests = json.loads(r.read())["ranks"]
        export_model = tq.init_params(mcfg, torch.Generator().manual_seed(0), device="cpu")
        specs = tq.param_partition_specs(mcfg)
        own = dict(export_model.named_parameters())
        assert digests == [{n: tde.tensor_digest(tq.tp_slice(own[n], tq.leaf_spec(specs, n), 2, r)) for n in names}
                           for r in range(2)]
        body = json.dumps({"input_ids": [5, 6, 7, 8], "sampling_params": {"max_new_tokens": 5, "greedy": True}})
        req = urllib.request.Request(f"http://{addr}/generate", data=body.encode(),
                                     headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert len(json.loads(r.read())["output_tokens"]) == 5
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == EXIT_CODE
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    t0 = time.monotonic()
    while _alive(pids) and time.monotonic() - t0 < 10:
        time.sleep(0.1)
    assert pids and not _alive(pids), proc.stdout.read()[-2000:]


def test_rank_heads_pass_the_kernel_checks():
    """Qwen2.5-1.5B on ``model=2``: a rank computes with 6 heads and 1 KV
    head (G = 6), half the FFN and half the vocabulary, which kernel #1's
    head check takes; with one KV head the split picker gives the 32 slots
    at least as many splits of a 2,048-token window as with two. On
    ``model=4`` the 2 KV heads do not divide: uneven tensor parallelism."""
    from areal_tpu_torch.ops import paged_attention as pa_ops
    from areal_tpu_torch.ops import paged_suffix_attention as psa_ops

    cfg = tq.ModelConfig(vocab_size=151936, hidden_size=1536, intermediate_size=8960, num_layers=28, num_heads=12,
                         num_kv_heads=2, head_dim=128)
    lc = tq.local_config(cfg, 2)
    assert (lc.num_heads, lc.num_kv_heads, lc.head_dim_, lc.intermediate_size, lc.vocab_size) == (6, 1, 128, 4480,
                                                                                                   75968)
    pa_ops.check_heads(lc.num_heads, lc.num_kv_heads, lc.head_dim_, 128)
    one, two = (psa_ops.pick_splits(32, kh, 1, 6, 16, 128, 132) for kh in (1, 2))
    assert one >= two >= 1
    with pytest.raises(NotImplementedError, match="6b"):
        tq.local_config(cfg, 4)
