"""The port's qwen3_moe model against the JAX model on the same weights, on
the CPU: the four serving forwards (cold prefill, paged decode step, warm
suffix prefill over cached pages, speculative verify) and the decode
engine's greedy tokens.

The tiny config has what Qwen3-30B-A3B has and the dense twins lack: an MoE
FFN (8 experts, top-2, dropless), qk-norm, no bias, an untied LM head, and
H * hd = 64 != D = 32. f32 weights and caches on both sides, so the same
arithmetic summed in other orders (and routing identical) is the bar."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.models import qwen as jq
from areal_tpu_torch.api.config import ServerConfig, SpeculativeConfig
from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest
from areal_tpu_torch.inference import speculative as tspec
from areal_tpu_torch.inference.decode_engine import DecodeEngine
from areal_tpu_torch.models import qwen as tq

from test_torch_moe import MOE_CFG
from test_torch_qwen import jax_params, port_model, to_torch

F32_TOL = dict(atol=2e-5, rtol=2e-5)
PSZ = 8


@pytest.fixture(scope="module")
def weights():
    assert MOE_CFG.q_dim != MOE_CFG.hidden_size and MOE_CFG.num_experts > 0
    return jax_params(MOE_CFG, seed=21)


@pytest.fixture(scope="module")
def model(weights):
    return port_model(MOE_CFG, weights)


def _jp(weights):
    return jax.tree.map(jnp.asarray, weights)


def _cache(seed, n_pages=12):
    rng = np.random.default_rng(seed)
    shape = (MOE_CFG.num_layers, MOE_CFG.num_kv_heads, n_pages, PSZ, MOE_CFG.head_dim_)
    raw = {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}
    return {n: jnp.asarray(a) for n, a in raw.items()}, {n: torch.from_numpy(a.copy()) for n, a in raw.items()}


def test_forward_prefill_matches_jax(weights, model):
    rng = np.random.default_rng(1)
    A, P = 3, 13
    ids = rng.integers(0, MOE_CFG.vocab_size, (A, P)).astype(np.int32)
    pos = np.broadcast_to(np.arange(P, dtype=np.int32), (A, P)).copy()
    seg = (np.arange(P)[None] < np.array([[13], [6], [9]])).astype(np.int32)
    jh, jks, jvs = jq.forward_prefill(_jp(weights), MOE_CFG, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(seg))
    with torch.no_grad():
        th, tks, tvs = tq.forward_prefill(model, to_torch(ids), to_torch(pos), to_torch(seg))
        tl = tq.compute_logits(model, th)
    jl = jq.compute_logits(_jp(weights), MOE_CFG, jh)
    valid = seg.astype(bool)
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid], **F32_TOL)
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), **F32_TOL)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), **F32_TOL)
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], **F32_TOL)


def test_decode_step_matches_jax(weights, model):
    """One ``forward_decode_paged`` step (MoE over [S, 1, D]) from the same
    f32 cache: hidden states and the cache after the step's writes."""
    rng = np.random.default_rng(5)
    S, wp = 4, 3
    ids = rng.integers(0, MOE_CFG.vocab_size, S).astype(np.int32)
    positions = np.array([0, 7, 8, 20], np.int32)
    pt = np.array([[1, 0, 0], [2, 0, 0], [3, 4, 0], [5, 6, 7]], np.int32)
    jcache, tcache = _cache(5)
    jh, jc = jq.forward_decode_paged(
        _jp(weights), MOE_CFG, jnp.asarray(ids), jnp.asarray(positions), dict(jcache), jnp.asarray(pt),
        page_size=PSZ, use_kernel=False,
    )
    with torch.no_grad():
        th, tc = tq.forward_decode_paged(model, to_torch(ids), to_torch(positions), tcache, to_torch(pt),
                                         page_size=PSZ)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **F32_TOL)


def test_forward_prefill_paged_matches_jax(weights, model):
    """Warm suffix prefill over cached prefix pages (the chain mask)."""
    rng = np.random.default_rng(11)
    jcache, tcache = _cache(11)
    pt = np.array([[3, 7, 1, 0], [5, 2, 9, 11]], np.int32)
    A, B = 2, 9
    plens = np.array([3 * PSZ, 2 * PSZ], np.int32)
    ids = rng.integers(0, MOE_CFG.vocab_size, (A, B)).astype(np.int32)
    positions = (plens[:, None] + np.arange(B)[None]).astype(np.int32)
    seg = (np.arange(B)[None] < np.array([9, 5])[:, None]).astype(np.int32)
    jh, jks, jvs = jq.forward_prefill_paged(
        _jp(weights), MOE_CFG, jnp.asarray(ids), jnp.asarray(positions), jnp.asarray(seg), dict(jcache),
        jnp.asarray(pt), jnp.asarray(plens), use_kernel=False,
    )
    with torch.no_grad():
        th, tks, tvs = tq.forward_prefill_paged(
            model, to_torch(ids), to_torch(positions), to_torch(seg), tcache, to_torch(pt), to_torch(plens)
        )
    valid = seg.astype(bool)  # padded rows go to the trash page on every path
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid], **F32_TOL)
    np.testing.assert_allclose(tks.numpy()[:, valid], np.asarray(jks)[:, valid], **F32_TOL)
    np.testing.assert_allclose(tvs.numpy()[:, valid], np.asarray(jvs)[:, valid], **F32_TOL)


def test_forward_verify_paged_matches_jax(weights, model):
    """Speculative verify of draft trees (the ancestor mask)."""
    from areal_tpu.api.config import SpeculativeConfig as JSpecConfig
    from areal_tpu.inference import speculative as jspec

    jcache, tcache = _cache(12)
    pt = np.array([[3, 7, 1, 0], [5, 2, 9, 11]], np.int32)
    kw = dict(enabled=True, drafter="tree", spec_depth=3, tree_width=2, max_ngram=2)
    B = SpeculativeConfig(**kw).max_nodes()
    ctx = {0: [4, 5, 6, 4, 5, 6, 4, 5], 1: [9, 8, 9, 8, 9]}
    bundle = jspec.draft_batch(jspec.build_drafter(JSpecConfig(**kw)), ctx, 2, B - 1)
    tbundle = tspec.draft_batch(tspec.build_drafter(SpeculativeConfig(**kw)), ctx, 2, B - 1)
    np.testing.assert_array_equal(tbundle.mask, bundle.mask)
    assert bundle.n_draft.min() > 0
    pos0 = np.array([19, 3 * PSZ], np.int32)  # mid-page and page-aligned roots
    ids = np.concatenate([np.array([[7], [3]]), bundle.tokens], axis=1).astype(np.int32)
    depth = np.concatenate([np.zeros((2, 1), np.int32), bundle.depth], axis=1)
    positions = (pos0[:, None] + depth).astype(np.int32)
    jh, jks, jvs = jq.forward_verify_paged(
        _jp(weights), MOE_CFG, jnp.asarray(ids), jnp.asarray(positions), jnp.asarray(bundle.mask), dict(jcache),
        jnp.asarray(pt), jnp.asarray(pos0), use_kernel=False,
    )
    with torch.no_grad():
        th, tks, tvs = tq.forward_verify_paged(
            model, to_torch(ids), to_torch(positions), torch.from_numpy(bundle.mask), tcache, to_torch(pt),
            to_torch(pos0),
        )
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32_TOL)
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), **F32_TOL)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), **F32_TOL)


def test_engine_greedy_matches_jax_teacher_forced_argmax(weights, model):
    """The port's engine at the default prefix-cache settings serves the MoE
    model greedily: a cold request, then one sharing its first two pages (a
    radix hit: warm suffix prefill). Every token must be the JAX model's
    argmax given the prompt and the tokens before it (one teacher-forced
    forward per request, padded to 32 rows)."""
    rng = np.random.default_rng(3)
    first = rng.integers(1, 250, 20).tolist()
    second = first[:2 * PSZ] + rng.integers(1, 250, 5).tolist()
    n_new = 8
    cfg = ServerConfig(max_batch_size=4, max_seq_len=64, page_size=PSZ, decode_steps_per_call=4, seed=0)
    eng = DecodeEngine(cfg, params=port_model(MOE_CFG, weights), device="cpu")
    eng.start()
    try:
        outs = [
            eng.generate_sync(ModelRequest(input_ids=p, gconfig=GenerationHyperparameters(
                max_new_tokens=n_new, greedy=True)), timeout=240).output_tokens
            for p in (first, second)
        ]
    finally:
        eng.stop()
    assert eng.stats["prefix_cache_hits"] == 1 and eng.stats["prefix_hit_tokens"] == 2 * PSZ
    for prompt, out in zip((first, second), outs):
        assert len(out) == n_new
        seq = prompt + out[:-1]
        L, Lp = len(seq), 32
        ids = np.zeros((1, Lp), np.int32)
        ids[0, :L] = seq
        seg = (np.arange(Lp) < L).astype(np.int32)[None]
        pos = np.where(seg[0], np.arange(Lp), 0).astype(np.int32)[None]
        h = jq.forward(_jp(weights), MOE_CFG, jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(pos), with_aux=True)[0]
        logits = np.asarray(jq.compute_logits(_jp(weights), MOE_CFG, h))[0]
        want = logits[len(prompt) - 1 : L].argmax(-1).tolist()
        assert out == want, (out, want)


def test_moe_model_config_keeps_dense_fields_out(model):
    leaves = dict(model.named_parameters())
    assert not any(n.endswith(("w_gate", "w_up", "w_down")) for n in leaves)
    assert leaves["layers.0.w_router"].shape == (MOE_CFG.hidden_size, MOE_CFG.num_experts)
    assert dataclasses.asdict(model.cfg)["moe_dropless"] is True
