"""LoRA in the port against the JAX package on the CPU: the adapter shapes,
the forward with adapters (and with B = 0, exactly the base), ``merge_lora``,
two ``train_batch`` steps of the adapters over a frozen base (attention and
FFN targets, and through tree training), the server-side fold of adapter
updates (in process and over HTTP), the engine's export, recover state and
HF load, the ``lora_only`` fallback, and the outputs ``dots_nobatch`` saves.
Weights cross through ``models/convert.py``; inputs come from numpy seeds."""

import dataclasses
import logging
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.config import MeshConfig as JMeshConfig
from areal_tpu.api.config import NormConfig as JNormConfig
from areal_tpu.api.config import OptimizerConfig as JOptimizerConfig
from areal_tpu.api.config import PPOActorConfig as JPPOActorConfig
from areal_tpu.api.io_struct import FinetuneSpec as JFinetuneSpec
from areal_tpu.engine import train_engine as jte
from areal_tpu.models import qwen as jq
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu.trainer import ppo as jppo
from areal_tpu_torch.api.config import InferenceEngineConfig, NormConfig, OptimizerConfig, PPOActorConfig, ServerConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec, SaveLoadMeta, WeightUpdateMeta
from areal_tpu_torch.engine import train_engine as tte
from areal_tpu_torch.inference.client import RemoteTorchEngine
from areal_tpu_torch.inference.decode_engine import DecodeEngine
from areal_tpu_torch.inference.server import ServerThread
from areal_tpu_torch.models import convert
from areal_tpu_torch.models import qwen as tq
from areal_tpu_torch.trainer import ppo as tppo

import test_torch_tree_training as tree_twin
from test_torch_qwen import F32_TOL, jax_params, port_cfg
from test_torch_remat import _saved_by_jax, _saved_by_port
from test_torch_train_engine import COMMON, LR, STAT_RTOL, _rl_batch
from tpu_testing import TINY_QWEN2

RANK = 4
TARGETS = {"attn": ("wq", "wk", "wv", "wo"), "ffn": ("w_gate", "w_up", "w_down")}
# the served weights after folds against merge_lora of the latest adapters
# (JAX's test_lora_delta_weight_update_folds_on_server)
FOLD_ATOL = 3e-5


def _jcfg(targets=TARGETS["attn"]):
    return dataclasses.replace(TINY_QWEN2, lora_rank=RANK, lora_targets=tuple(targets))


def _lora_params(jcfg, seed: int) -> dict:
    """JAX init with adapters, random biases / norms, and a random B (init
    leaves B at 0, where A's gradient is 0 too)."""
    p = jax_params(jcfg, seed=seed)
    rng = np.random.default_rng(seed + 100)
    for t in jcfg.lora_targets:
        b = p["layers"][f"{t}_lora_b"]
        p["layers"][f"{t}_lora_b"] = (0.02 * rng.standard_normal(b.shape)).astype(b.dtype)
    return p


def _grid(seed=0, G=2, L=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY_QWEN2.vocab_size, (G, L)).astype(np.int32)
    seg = np.ones((G, L), np.int32)
    seg[1, 20:] = 2
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (G, L)).copy()
    pos[1, 20:] = np.arange(L - 20)
    return ids, seg, pos


def _port(jcfg, params) -> tq.QwenModel:
    cfg = port_cfg(jcfg)
    model = tq.QwenModel(cfg, device="cpu")
    model.load_state_dict(convert.from_jax_params(params, cfg))
    return model


@pytest.mark.parametrize("targets", ["attn", "ffn", "norm", "unknown"])
def test_lora_shapes_match_jax(targets):
    """The port's adapter shapes are JAX's transposed; a target that is not a
    2-D layer projection raises ``ValueError`` on both sides."""
    t = {**TARGETS, "norm": ("input_norm",), "unknown": ("w_nope",)}[targets]
    jcfg = _jcfg(t)
    if targets in ("norm", "unknown"):
        with pytest.raises(ValueError):
            jq.init_lora_params(jax.random.PRNGKey(0), jcfg)
        with pytest.raises(ValueError, match="not a 2-D layer projection"):
            tq.QwenModel(port_cfg(jcfg), device="cpu")
        return
    want = jq._lora_shapes(jcfg)
    got = tq._lora_shapes(port_cfg(jcfg))
    assert got.keys() == want.keys()
    assert all(got[k] == want[k][::-1] for k in want)


@pytest.mark.parametrize("path", ["grid", "prefill", "decode"])
def test_zero_b_forward_equals_base(path):
    """Freshly initialized adapters (B = 0) leave every forward exactly the
    base model's (bit for bit)."""
    cfg = port_cfg(_jcfg())
    lora = tq.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(not p.any() for n, p in lora.named_parameters() if n.endswith("_lora_b"))
    assert all(p.any() for n, p in lora.named_parameters() if n.endswith("_lora_a"))
    base = tq.QwenModel(dataclasses.replace(cfg, lora_rank=0), device="cpu")
    base.load_state_dict({n: t for n, t in lora.state_dict().items() if "_lora_" not in n})
    ids, seg, pos = map(torch.from_numpy, _grid())

    def run(model):
        if path == "grid":
            return tq.forward(model, ids, seg, pos)
        if path == "prefill":
            return tq.forward_prefill(model, ids, pos)[0]
        from areal_tpu_torch.inference import paged_kv

        cache = paged_kv.init_paged_cache(model.cfg, n_pages=5, page_size=16)
        pt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
        return tq.forward_decode_paged(model, ids[:, 0], pos[:, 5], cache, pt, page_size=16)[0]

    with torch.no_grad():
        assert torch.equal(run(lora), run(base))


@pytest.mark.parametrize("targets", ["attn", "ffn"])
def test_lora_forward_matches_jax(targets):
    """The adapted forward (random A and B) against JAX's, f32 (``F32_TOL``)."""
    jcfg = _jcfg(TARGETS[targets])
    params = _lora_params(jcfg, seed=1)
    ids, seg, pos = _grid(seed=2)
    want = np.asarray(jq.forward(jax.tree.map(jnp.asarray, params), jcfg, *map(jnp.asarray, (ids, seg, pos))))
    with torch.no_grad():
        got = tq.forward(_port(jcfg, params), *map(torch.from_numpy, (ids, seg, pos))).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    base_params = {**params, "layers": {k: v for k, v in params["layers"].items() if "_lora_" not in k}}
    base = np.asarray(jq.forward(jax.tree.map(jnp.asarray, base_params), dataclasses.replace(jcfg, lora_rank=0),
                                 *map(jnp.asarray, (ids, seg, pos))))
    assert np.abs(want - base).max() > 1e-3  # the adapters matter


def test_merge_lora_matches_jax():
    """``merge_lora`` against JAX's (f32, within 1e-7 plus 1e-6 relative: the
    rank sum in another order), without adapter leaves; the merged model's
    forward equals the adapted one within 2e-5 (JAX's bound)."""
    jcfg = _jcfg()
    params = _lora_params(jcfg, seed=3)
    want = jax.tree.map(np.asarray, jq.merge_lora(jax.tree.map(jnp.asarray, params), jcfg))
    model = _port(jcfg, params)
    merged = tq.merge_lora(model.state_dict(), model.cfg)
    assert not any("_lora_" in n for n in merged)
    base_cfg = dataclasses.replace(model.cfg, lora_rank=0)
    got = convert.to_jax_params(merged, base_cfg)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_w.keys() == flat_g.keys()
    for k in flat_w:
        np.testing.assert_allclose(flat_g[k], flat_w[k], atol=1e-7, rtol=1e-6, err_msg=jax.tree_util.keystr(k))
    base = tq.QwenModel(base_cfg, device="cpu")
    base.load_state_dict(merged)
    ids, seg, pos = map(torch.from_numpy, _grid(seed=4))
    with torch.no_grad():
        np.testing.assert_allclose(tq.forward(base, ids, seg, pos).numpy(), tq.forward(model, ids, seg, pos).numpy(),
                                   atol=2e-5)


def _engines(targets=TARGETS["attn"], tree: bool = False, seed: int = 5):
    """A JAX LoRA engine on one CPU device and the port's, the port loaded
    with the JAX engine's weights (random biases, norms and B)."""
    common = dict(tree_twin.COMMON) if tree else dict(COMMON)
    lora = dict(lora_rank=RANK, lora_targets=list(targets))
    group = common["group_size"]
    jcfg = JPPOActorConfig(init_from_scratch=True, mesh=JMeshConfig(data=1), optimizer=JOptimizerConfig(lr=LR),
                           adv_norm=JNormConfig(mean_level="group", std_level="batch", group_size=group),
                           **common, **lora)
    jeng = jte.JaxTrainEngine(jcfg, model_config=TINY_QWEN2)
    jeng.initialize(JFinetuneSpec(1, 128, 16), mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    params = _lora_params(_jcfg(targets), seed)
    jeng.params = jax.tree.map(lambda old, new: jax.device_put(jnp.asarray(new), old.sharding), jeng.params, params)
    tcfg = PPOActorConfig(optimizer=OptimizerConfig(lr=LR),
                          adv_norm=NormConfig(mean_level="group", std_level="batch", group_size=group),
                          **common, **lora)
    teng = tte.TorchTrainEngine(tcfg, model_config=port_cfg(TINY_QWEN2), device="cpu")
    teng.initialize(FinetuneSpec(1, 128, 16))
    teng.model.load_state_dict(convert.from_jax_params(params, teng.model.cfg))
    return jcfg, jeng, tcfg, teng


def _wfn(d):
    return float((np.asarray(d["loss_mask"]) > 0).sum())


# JAX's tree forward (``areal_tpu/ops/tree_attention.py:458``) multiplies by
# ``layer["wo"]`` directly, so its tree path drops a ``wo`` adapter (ROADMAP
# Queue C, C-ref 5); the tree twin adapts q, k and v, and
# ``test_tree_path_keeps_every_adapter`` holds the port's tree path with a
# ``wo`` adapter to its own packed path
TREE_TARGETS = ("wq", "wk", "wv")


@pytest.mark.parametrize("case", ["attn", "ffn", "tree"])
def test_lora_train_steps_match_jax(case):
    """Two optimizer steps (the first at LR 0) against a LoRA
    ``JaxTrainEngine``: loss, grad_norm (over the adapters only) and stats
    of each step, then the adapters within the train-engine twin's bounds;
    every base leaf bit-unchanged on both sides, and the base has neither
    gradient nor AdamW moments."""
    targets = {"attn": TARGETS["attn"], "ffn": TARGETS["ffn"], "tree": TREE_TARGETS}[case]
    jcfg, jeng, tcfg, teng = _engines(targets, tree=case == "tree")
    batch = tree_twin._batch(seed=6) if case == "tree" else _rl_batch(7)
    batch["prox_logp"] = jeng.forward_batch(batch)
    adv = jppo.PPOActor(jcfg, SimpleNamespace(get_version=lambda: 0)).compute_advantages(batch)
    cfg = teng.model.cfg
    init = dict(jax.tree_util.tree_leaves_with_path(convert.to_jax_params(teng.model.state_dict(), cfg)))
    for step in range(2):
        want = jeng.train_batch(adv, lambda o, b: jppo.grpo_loss_fn(o, b, jcfg), _wfn)
        got = teng.train_batch(adv, lambda o, b: tppo.grpo_loss_fn(o, b, tcfg), _wfn)
        assert got["n_microbatches"] == want["n_microbatches"]
        for k in ("loss", "grad_norm", "actor_loss", "importance_weight", "entropy", "n_valid_tokens"):
            np.testing.assert_allclose(got[k], want[k], rtol=STAT_RTOL, atol=1e-6, err_msg=f"step {step}: {k}")
    assert want["grad_norm"] > 0
    assert all(p.grad is None for n, p in teng.model.named_parameters() if "_lora_" not in n)
    assert len(teng._opt.mu) == 2 * len(targets) * cfg.num_layers
    flat_g = dict(jax.tree_util.tree_leaves_with_path(convert.to_jax_params(teng.model.state_dict(), cfg)))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jeng.params)))
    assert flat_g.keys() == flat_j.keys()
    for key in flat_j:
        if "_lora_" not in jax.tree_util.keystr(key):
            np.testing.assert_array_equal(flat_g[key], init[key], err_msg=jax.tree_util.keystr(key))
            np.testing.assert_array_equal(flat_j[key], init[key], err_msg=jax.tree_util.keystr(key))
            continue
        diff = np.abs(flat_g[key] - flat_j[key])
        assert diff.max() <= 2 * LR, (key, diff.max())
        assert np.mean(diff <= 1e-6) > 0.99, (key, np.mean(diff <= 1e-6))
        assert np.abs(flat_j[key] - init[key]).max() > LR / 2, key  # the second step moved it


def test_tree_path_keeps_every_adapter():
    """The port's tree path with adapters on q, k, v and o gives its packed
    path's loss and gradients (f32, ``STAT_RTOL`` / 1e-5 of each leaf's
    largest entry): no adapter is dropped."""
    jcfg, jeng, tcfg, teng = _engines(TARGETS["attn"], tree=True)
    batch = tree_twin._batch(seed=8)
    batch["prox_logp"] = jeng.forward_batch(batch)
    adv = jppo.PPOActor(jcfg, SimpleNamespace(get_version=lambda: 0)).compute_advantages(batch)
    res = {}
    for tree in (True, False):
        teng.config = PPOActorConfig(**{**tcfg.__dict__, "tree_training": tree})
        teng.zero_grad()
        stats = teng.compute_grads(adv, lambda o, b: tppo.grpo_loss_fn(o, b, tcfg), _wfn)
        res[tree] = stats, {n: p.grad.clone() for n, p in teng.model.named_parameters() if p.grad is not None}
    teng.zero_grad()
    np.testing.assert_allclose(res[True][0]["loss"], res[False][0]["loss"], rtol=STAT_RTOL)
    assert res[True][1].keys() == res[False][1].keys() and any("wo_lora" in n for n in res[True][1])
    for n, g in res[False][1].items():
        scale = float(g.abs().max())
        assert scale > 0, n
        np.testing.assert_allclose(res[True][1][n].numpy(), g.numpy(), atol=1e-5 * scale, rtol=0, err_msg=n)


def _scratch_engine(lora: bool = True, seed: int = 3):
    cfg = PPOActorConfig(dtype="float32", param_dtype="float32", bucket_step=64,
                         optimizer=OptimizerConfig(lr=1e-2, lr_scheduler_type="constant"),
                         lora_rank=RANK if lora else 0)
    teng = tte.TorchTrainEngine(cfg, model_config=port_cfg(TINY_QWEN2), device="cpu")
    teng.initialize(FinetuneSpec(1, 16, 4), seed=seed)
    return teng


def _lm_loss(outputs, b):
    m = (b["label_valid"] & (b["loss_mask"] > 0)).float()
    return -(outputs["logprobs"] * m).sum() / m.sum().clamp(min=1.0), {}


def _lm_batch(rng, B=4, L=16):
    return {"input_ids": rng.integers(1, 256, (B, L)).astype(np.int32),
            "attention_mask": np.ones((B, L), np.int64), "loss_mask": np.ones((B, L), np.float32)}


@pytest.mark.parametrize("how", ["in_process", "http"])
def test_lora_fold_on_server_matches_merge(how):
    """A server started from the adapter-free export takes two adapter-only
    updates (``update_weights`` with ``lora_only``: in process, or through
    the client's ``/update_weights_lora``) after two steps each; its weights
    then equal ``merge_lora`` of the latest adapters within ``FOLD_ATOL``
    (the wire rounds the adapters to bf16 over HTTP), its version 2."""
    teng = _scratch_engine()
    assert not any("_lora_" in n for n in teng._export_params())
    scfg = ServerConfig(max_batch_size=2, max_seq_len=64, page_size=16, decode_steps_per_call=2, seed=0,
                        host="127.0.0.1")
    base_cfg = dataclasses.replace(teng.model_cfg, lora_rank=0)
    dec = DecodeEngine(scfg, params=teng._export_params(), model_cfg=base_cfg, device="cpu")
    srv = client = None
    meta = WeightUpdateMeta(type="mem", lora_only=True)
    if how == "http":
        srv = ServerThread(scfg, engine=dec)
        srv.start()
        client = RemoteTorchEngine(InferenceEngineConfig(request_timeout=60), addresses=[srv.address])
        client.initialize()
        teng.connect_engine(client, meta)
    else:
        dec.initialize()
        teng.connect_engine(dec, meta)
    rng = np.random.default_rng(3)
    try:
        for _ in range(2):
            for _ in range(2):  # the first step of all has LR 0
                teng.train_batch(_lm_batch(rng), _lm_loss, _wfn)
            teng.update_weights()
        assert dec.get_version() == 2
        if client is not None:
            assert client.get_version() == 2 and client.last_update_gen_tokens == 0
    finally:
        if client is not None:
            client.destroy()
        if srv is not None:
            srv.stop()
    state = {n: p.detach() for n, p in teng.model.named_parameters()}
    if how == "http":  # the adapters traveled as bf16
        state = {n: t.to(torch.bfloat16).float() if "_lora_" in n else t for n, t in state.items()}
    merged = tq.merge_lora(state, teng.model_cfg)
    served = dict(dec.model.named_parameters())
    moved = 0.0
    for n, want in merged.items():
        np.testing.assert_allclose(served[n].detach().numpy(), want.numpy(), atol=FOLD_ATOL, rtol=0, err_msg=n)
        moved = max(moved, float((want - teng.model.state_dict()[n]).abs().max()) if n.split(".")[-1] in
                    TARGETS["attn"] else 0.0)
    assert moved > 10 * FOLD_ATOL  # the adapters moved the targets


def test_lora_export_recover_state_and_hf_load(tmp_path):
    """The HF export is the merged tree; the recover state carries the
    adapters and their moments (and no moments of the base), and loads back
    bit for bit; an HF load puts fresh adapters (B = 0) over the merged
    base, as JAX does, so the forward is the merged model's."""
    teng = _scratch_engine()
    rng = np.random.default_rng(4)
    for _ in range(2):
        teng.train_batch(_lm_batch(rng), _lm_loss, _wfn)
    lora_bytes = sum(p.numel() * 4 for n, p in teng.model.named_parameters() if "_lora_" in n)
    assert teng.hbm_ledger()["components"]["opt_state"] == 2 * lora_bytes
    teng.save(SaveLoadMeta(path=str(tmp_path / "rec"), weight_format="state", with_optim=True))
    other = _scratch_engine(seed=9)
    other.load(SaveLoadMeta(path=str(tmp_path / "rec"), weight_format="state", with_optim=True))
    for (n, a), (_, b) in zip(teng.model.named_parameters(), other.model.named_parameters()):
        assert torch.equal(a, b), n
    assert all(torch.equal(a, b) for a, b in zip(teng._opt.mu + teng._opt.nu, other._opt.mu + other._opt.nu))
    assert other._opt.count == teng._opt.count == 2
    teng.save(SaveLoadMeta(path=str(tmp_path / "hf"), weight_format="hf"))
    other.load(SaveLoadMeta(path=str(tmp_path / "hf"), weight_format="hf"))
    merged = teng._export_params()
    for n, p in other.model.named_parameters():
        if n.endswith("_lora_b"):
            assert not p.any(), n
        elif "_lora_" not in n:
            assert torch.equal(p.detach(), merged[n]), n
    ids, seg, pos = map(torch.from_numpy, _grid(seed=5))
    view = tq.ParamView(other.model, other.model_cfg)
    base = tq.QwenModel(dataclasses.replace(teng.model_cfg, lora_rank=0), device="cpu")
    base.load_state_dict(merged)
    with torch.no_grad():
        assert torch.equal(tq.forward(view, ids, seg, pos), tq.forward(base, ids, seg, pos))


def test_lora_only_on_non_lora_model_falls_back(caplog):
    """``lora_only`` on a model without adapters warns and pushes the full
    tree (JAX's fallback)."""
    teng = _scratch_engine(lora=False)
    scfg = ServerConfig(max_batch_size=2, max_seq_len=64, page_size=16, decode_steps_per_call=2, seed=0)
    other = tq.init_params(teng.model_cfg, torch.Generator().manual_seed(7), device="cpu")
    dec = DecodeEngine(scfg, params=other, device="cpu")
    dec.initialize()
    teng.connect_engine(dec, WeightUpdateMeta(type="mem", lora_only=True))
    with caplog.at_level(logging.WARNING, logger="areal_tpu_torch.train_engine"):
        teng.update_weights()
    assert "non-LoRA model" in caplog.text and dec.get_version() == 1
    served = dict(dec.model.named_parameters())
    assert all(torch.equal(served[n], p) for n, p in teng._export_params().items())


@pytest.mark.parametrize("targets", ["attn", "ffn"])
def test_dots_nobatch_saves_the_adapter_products(targets, monkeypatch):
    """Under "dots_nobatch" a layer with adapters saves JAX's residuals: the
    base set plus x @ A and (x @ A) @ B of each target, where the down
    projection keeps only x @ A (B's gradient reads it; nothing reads the
    product, which JAX neither saves nor recomputes)."""
    jcfg = _jcfg(TARGETS[targets])
    got = _saved_by_port(jcfg, monkeypatch)
    want = _saved_by_jax(jcfg)
    T = 2 * 64
    assert got == want
    n_products = 2 * len(TARGETS[targets]) - (targets == "ffn")
    assert len(got) == 6 + n_products and got.count((T, RANK)) == len(TARGETS[targets])
