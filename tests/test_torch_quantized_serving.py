"""int8 weight-only serving in the port (``ServerConfig.quantization="int8"``)
against the JAX package: ``quantize_dense_int8`` / ``quantize_params_int8``
bit for bit, the quantized forward, the int8 engine's greedy tokens, full
updates that re-quantize (params, staged buckets on either target, a disk
reload), the q8 wire over the port's HTTP server, the refusals, the
offload round trip and ``resolve_weight_update_wire``. Weights cross
through ``models/convert.py``; inputs come from numpy seeds."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.config import MeshConfig as JMeshConfig
from areal_tpu.api.config import ServerConfig as JServerConfig
from areal_tpu.api.io_struct import GenerationHyperparameters as JGen
from areal_tpu.api.io_struct import ModelRequest as JRequest
from areal_tpu.inference import decode_engine as jde
from areal_tpu.models import qwen as jq
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu.trainer import rl_trainer as jrl
from areal_tpu_torch.api.config import InferenceEngineConfig, ServerConfig
from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest, WeightUpdateMeta
from areal_tpu_torch.inference.client import RemoteTorchEngine
from areal_tpu_torch.inference.decode_engine import DecodeEngine
from areal_tpu_torch.inference.server import ServerThread
from areal_tpu_torch.models import convert, hf
from areal_tpu_torch.models import qwen as tq
from areal_tpu_torch.trainer import rl_trainer as trl

from test_torch_decode_engine import _run_all
from test_torch_moe import MOE_CFG
from test_torch_qwen import F32_TOL, jax_params, port_cfg, port_model
from tpu_testing import TINY_QWEN2

SERVER_KW = dict(max_batch_size=4, max_seq_len=128, page_size=16, decode_steps_per_call=4, seed=0)
# greedy logprobs of two engines on the same int8 tables (f32 serving): the
# XLA and PyTorch sums in other orders
LOGP_ATOL = 1e-4


def _w_cases():
    rng = np.random.default_rng(0)
    ties = np.zeros((6, 8), np.float32)
    ties[:, 0] = 127.0  # scale 1: every other entry is its own quotient
    ties[:, 1:] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    ties[5] = 0.0  # an all-zero channel: the 1e-12 floor
    return {
        "f32": (0.02 * rng.standard_normal((2, 48, 40))).astype(np.float32),
        "bf16": np.asarray(jnp.asarray(rng.standard_normal((40, 24)), jnp.bfloat16)),
        "ties_and_zero_channel": ties,
    }


@pytest.mark.parametrize("case", list(_w_cases()))
def test_quantize_dense_int8_matches_jax(case):
    """q8 and scale bit for bit (exact); the port takes [..., out, in], JAX
    [..., in, out]."""
    w = _w_cases()[case]  # the port's layout
    wj = np.swapaxes(w, -1, -2)
    jq8, js = jq.quantize_dense_int8(jnp.asarray(wj))
    q8, s = tq.quantize_dense_int8(convert._to_tensor(w))
    assert q8.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q8.numpy(), np.swapaxes(np.asarray(jq8), -1, -2))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[..., 0, :])
    if case == "ties_and_zero_channel":  # half to even on both sides, and the floor
        assert q8[0, 1:].tolist() == [0, 2, 2, 0, -2, -2, 126]
        assert s[5].item() == np.float32(1e-12) and not q8[5].any()


@pytest.mark.parametrize("model", ["dense", "moe"])
def test_quantize_params_int8_matches_jax(model):
    """The whole served tree through the bridge: every leaf bit for bit
    (exact); MoE experts, embed and norms untouched."""
    jcfg = TINY_QWEN2 if model == "dense" else dataclasses.replace(MOE_CFG, dtype="float32")
    params = jax_params(jcfg, seed=1)
    want = jax.tree.map(np.asarray, jq.quantize_params_int8(params))
    got = convert.to_jax_params(tq.quantize_params_int8(convert.from_jax_params(params, port_cfg(jcfg))),
                                port_cfg(jcfg))
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_w.keys() == flat_g.keys()
    for k in flat_w:
        assert flat_g[k].dtype == flat_w[k].dtype, k
        np.testing.assert_array_equal(flat_g[k], flat_w[k], err_msg=jax.tree_util.keystr(k))


def test_quantized_prefill_logits_match_jax():
    """Prefill logits of the quantized model against JAX's quantized logits
    (f32, ``F32_TOL``), both within JAX's 5% of the unquantized ones."""
    params = jax_params(TINY_QWEN2, seed=2)
    qp = jq.quantize_params_int8(jax.tree.map(jnp.asarray, params))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, TINY_QWEN2.vocab_size, (2, 16)).astype(np.int32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    h, _, _ = jq.forward_prefill(qp, TINY_QWEN2, jnp.asarray(ids), jnp.asarray(pos))
    want = np.asarray(jq.compute_logits(qp, TINY_QWEN2, h))
    model = port_model(TINY_QWEN2, params)
    tq.quantize_model_int8(model)
    assert not hasattr(model.layers[0], "wq") and model.layers[0].wq_q8.dtype == torch.int8
    th, _, _ = tq.forward_prefill(model, torch.from_numpy(ids), torch.from_numpy(pos.copy()))
    got = tq.compute_logits(model, th).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    h0, _, _ = jq.forward_prefill(params, TINY_QWEN2, jnp.asarray(ids), jnp.asarray(pos))
    ref = np.asarray(jq.compute_logits(params, TINY_QWEN2, h0))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.05


def _jax_int8_engine(params, **over):
    jcfg = JServerConfig(**SERVER_KW, quantization="int8", mesh=JMeshConfig(data=1), **over)
    eng = jde.DecodeEngine(jcfg, params=jax.tree.map(jnp.asarray, params), model_cfg=TINY_QWEN2,
                           mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    eng.initialize()
    return eng


def _port_engine(params, quantization="int8", **over):
    cfg = ServerConfig(**SERVER_KW, quantization=quantization, **over)
    eng = DecodeEngine(cfg, params=convert.from_jax_params(params, port_cfg(TINY_QWEN2)),
                       model_cfg=port_cfg(TINY_QWEN2), device="cpu")
    eng.initialize()
    return eng


def _served(eng) -> dict[str, np.ndarray]:
    """The served tree in the JAX layout."""
    return convert.to_jax_params({n: p.detach() for n, p in eng.model.named_parameters()},
                                 eng.model_cfg)["layers"]


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_int8_engine_greedy_matches_jax_engine(kv):
    """The int8 engine's served tables equal JAX's bit for bit; greedy tokens
    of a cold wave and of a warm wave (radix hits: the suffix prefill over
    the cached pages) equal JAX's, logprobs within ``LOGP_ATOL``. The
    memory ledger counts the int8 tables."""
    params = jax_params(TINY_QWEN2, seed=4)
    jeng, teng = _jax_int8_engine(params, kv_quantization=kv), _port_engine(params, kv_quantization=kv)
    got_tables = _served(teng)
    for name, want in jeng.params["layers"].items():
        if name.endswith("_scale"):
            # JAX's engine quantizes under jit, where XLA turns the division
            # by 127 into a multiply by its reciprocal (its own q8-wire test
            # holds scales to this bound); the eager function is exact above
            np.testing.assert_allclose(got_tables[name], np.asarray(want), rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(got_tables[name], np.asarray(want), err_msg=name)
    ledger = teng.hbm_ledger()["components"]["params"]
    assert ledger == sum(p.numel() * p.element_size() for p in teng.model.parameters())
    rng = np.random.default_rng(5)
    system = rng.integers(0, 256, 32).tolist()
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 13, 20)]
    waves = [prompts, [system + p for p in prompts]]
    jeng.start()
    teng.start()
    try:
        for wave in [waves[0], waves[1][:1], waves[1][1:]]:  # the first warm request publishes the system prompt
            want = _run_all(jeng, [JRequest(input_ids=p, gconfig=JGen(max_new_tokens=12, greedy=True)) for p in wave])
            got = _run_all(teng, [ModelRequest(input_ids=p, gconfig=GenerationHyperparameters(
                max_new_tokens=12, greedy=True)) for p in wave])
            for w, g in zip(want, got):
                assert g.output_tokens == w.output_tokens
                np.testing.assert_allclose(g.output_logprobs, w.output_logprobs, atol=LOGP_ATOL)
    finally:
        jeng.stop()
        teng.stop()
    assert teng.stats["suffix_prefill_batches"] > 0 and teng.stats["prefix_hit_tokens"] > 0


def _apply(eng, how: str, new: dict, tmp_path, version: int) -> None:
    """A full bf16-named update of the port's ``new`` state dict by ``how``."""
    if how == "params":
        eng.update_weights_from_params(new, version=version)
    elif how == "disk":
        hf.save_params_to_hf(new, eng.model_cfg, str(tmp_path / "ckpt"))
        eng.update_weights_from_disk(str(tmp_path / "ckpt"), version=version)
    else:
        eng.begin_staged_update(how.split("_")[1])
        names = sorted(new)
        for half in (names[: len(names) // 2], names[len(names) // 2:]):
            eng.stage_weight_bucket({n: new[n] for n in half})
        eng.commit_staged_weights(version=version)


@pytest.mark.parametrize("how", ["params", "staged_device", "staged_host", "disk"])
def test_full_update_requantizes(how, tmp_path):
    """Every full update of bf16-named weights re-quantizes on apply: the
    served tables equal JAX's quantization of the new weights bit for bit,
    the other leaves are the new ones, and the version moves."""
    eng = _port_engine(jax_params(TINY_QWEN2, seed=6))
    new_j = jax_params(TINY_QWEN2, seed=7)
    _apply(eng, how, convert.from_jax_params(new_j, port_cfg(TINY_QWEN2)), tmp_path, 5)
    assert eng.get_version() == 5
    want = jax.tree.map(np.asarray, jq.quantize_params_int8(new_j))["layers"]
    got = _served(eng)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.fixture
def int8_server():
    params = jax_params(TINY_QWEN2, seed=8)
    cfg = ServerConfig(**SERVER_KW, quantization="int8", host="127.0.0.1")
    srv = ServerThread(cfg, engine=DecodeEngine(cfg, params=port_model(TINY_QWEN2, params), device="cpu"))
    srv.start()
    client = RemoteTorchEngine(InferenceEngineConfig(max_concurrent_rollouts=2, consumer_batch_size=1,
                                                     request_timeout=60, request_retries=1),
                               addresses=[srv.address])
    client.initialize()
    yield srv, client
    client.destroy()
    srv.stop()


def test_q8_wire_over_http(int8_server):
    """The q8 wire through the port's client and server serves what the
    server-side quantization of the same f32 weights gives, and JAX's
    ``quantize_dense_int8``, bit for bit; its wire bytes are the int8
    tables, f32 scales and bf16 rest; the engine generates after it."""
    srv, client = int8_server
    new_j = jax_params(TINY_QWEN2, seed=9)
    new = convert.from_jax_params(new_j, port_cfg(TINY_QWEN2))
    b0 = client._metrics.update_bytes.get()
    client.update_weights(WeightUpdateMeta(type="mem", wire_format="q8"), params=new)
    q8_bytes = client._metrics.update_bytes.get() - b0
    assert srv.engine.get_version() == 1 == client.get_version()
    server_side = tq.quantize_params_int8({k: v.to(torch.float32) for k, v in new.items()})
    served = dict(srv.engine.model.named_parameters())
    for n, want in server_side.items():
        if want.dtype == torch.float32 and not n.endswith("_scale"):
            want = want.to(torch.bfloat16).float()  # the rest of the tree travels as bf16
        assert torch.equal(served[n].detach(), want), n
    jwant = jax.tree.map(np.asarray, jq.quantize_params_int8(new_j))["layers"]
    for name, arr in _served(srv.engine).items():
        if name.endswith(("_q8", "_scale")):
            np.testing.assert_array_equal(arr, jwant[name], err_msg=name)
    wire = sum(client._wire_nbytes(k, v) for k, v in server_side.items())
    bf16 = sum(client._wire_nbytes(k, v) for k, v in new.items())
    assert q8_bytes >= wire and q8_bytes - wire < 4096  # the bucket headers
    assert wire < 0.75 * bf16
    r = srv.engine.generate_sync(ModelRequest(input_ids=[1, 2, 3, 4],
                                              gconfig=GenerationHyperparameters(max_new_tokens=4, greedy=True)))
    assert len(r.output_tokens) == 4 and r.output_versions == [1] * 4


def _weights(eng) -> dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in eng.model.named_parameters()}


def _lora_bucket(eng, seed: int) -> dict[str, np.ndarray]:
    """Adapters for wq in the JAX layout, random A and B."""
    rng = np.random.default_rng(seed)
    n, cfg = eng.model_cfg.num_layers, eng.model_cfg
    return {"layers/wq_lora_a": rng.normal(0, 0.01, (n, cfg.hidden_size, 4)).astype(np.float32),
            "layers/wq_lora_b": rng.normal(0, 0.01, (n, 4, cfg.q_dim)).astype(np.float32)}


@pytest.mark.parametrize("refusal", ["q8_wire_to_bf16", "lora_on_int8", "lora_after_full"])
def test_refusals_leave_weights_unchanged(refusal):
    """A q8-wire update to a bf16 server (refused at stage time, over
    HTTP), an adapter fold on an int8 engine (``RuntimeError`` naming int8)
    and an adapter fold after a full update (the fold's base is unknown)
    each raise and change no weight and no version."""
    params = jax_params(TINY_QWEN2, seed=10)
    if refusal == "q8_wire_to_bf16":
        cfg = ServerConfig(**SERVER_KW, host="127.0.0.1")
        srv = ServerThread(cfg, engine=DecodeEngine(cfg, params=port_model(TINY_QWEN2, params), device="cpu"))
        srv.start()
        client = RemoteTorchEngine(InferenceEngineConfig(request_timeout=30, request_retries=1),
                                   addresses=[srv.address])
        client.initialize()
        eng = srv.engine
        before = _weights(eng)
        try:
            with pytest.raises(RuntimeError):
                client.update_weights(WeightUpdateMeta(type="mem", wire_format="q8"),
                                      params=convert.from_jax_params(jax_params(TINY_QWEN2, seed=11),
                                                                     port_cfg(TINY_QWEN2)))
            assert eng._staged is None  # the client aborted the staged part
        finally:
            client.destroy()
            srv.stop()
        # the engine itself refuses a served-form leaf at stage time
        eng.begin_staged_update()
        with pytest.raises(RuntimeError, match="non-quantized"):
            eng.stage_weight_bucket({"layers.0.wq_q8": torch.zeros((64, 64), dtype=torch.int8)})
        eng.abort_staged_update()
    elif refusal == "lora_on_int8":
        eng = _port_engine(params)
        before = _weights(eng)
        with pytest.raises(RuntimeError, match="int8"):
            eng.update_weights_lora(_lora_bucket(eng, 1), scale=0.5, version=2)
    else:
        eng = _port_engine(params, quantization="none")
        eng.update_weights_lora(_lora_bucket(eng, 1), scale=0.5, version=1)  # a fold on the base: fine
        eng.update_weights_from_params(convert.from_jax_params(params, port_cfg(TINY_QWEN2)), version=2)
        before = _weights(eng)
        with pytest.raises(RuntimeError, match="after a full weight update"):
            eng.update_weights_lora(_lora_bucket(eng, 2), scale=0.5, version=3)
    after = _weights(eng)
    assert after.keys() == before.keys()
    assert all(torch.equal(after[n], before[n]) for n in before)
    assert eng.get_version() == (2 if refusal == "lora_after_full" else 0)


def test_offload_onload_roundtrip_int8():
    """release / resume memory carry the int8 tables and scales: the same
    bits back, and the engine generates after it."""
    eng = _port_engine(jax_params(TINY_QWEN2, seed=12))
    before = _weights(eng)
    assert before["layers.0.wq_q8"].dtype == torch.int8
    eng.pause_generation()
    eng.release_memory()
    assert eng.cache is None and eng.hbm_ledger()["components"]["params"] == 0
    eng.resume_memory()
    eng.continue_generation()
    after = _weights(eng)
    assert all(torch.equal(after[n], before[n]) for n in before)
    eng.start()
    try:
        r = eng.generate_sync(ModelRequest(input_ids=list(range(1, 9)),
                                           gconfig=GenerationHyperparameters(max_new_tokens=4, greedy=True)))
    finally:
        eng.stop()
    assert len(r.output_tokens) == 4


_SERVERS = {"absent": None, "no_field": SimpleNamespace(), "none": SimpleNamespace(quantization="none"),
            "int8": SimpleNamespace(quantization="int8")}


@pytest.mark.parametrize("server", list(_SERVERS))
@pytest.mark.parametrize("wire", [None, "", "auto", "bf16", "q8", "int8", "fp8"])
def test_resolve_weight_update_wire_matches_jax(wire, server):
    """The same wire, or a ``ValueError`` on both sides, for every wire and
    fleet (a config without the field, or without a server, included)."""
    cfg = SimpleNamespace(server=_SERVERS[server])
    if wire is not None:
        cfg.weight_update_wire = wire

    def run(fn):
        try:
            return fn(cfg)
        except ValueError as e:
            return ("ValueError", "int8" in str(e))

    assert run(trl.resolve_weight_update_wire) == run(jrl.resolve_weight_update_wire)

