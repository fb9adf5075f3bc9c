"""The port's Qwen model against the JAX model on the same weights.

Weights come from the JAX ``init_params`` with biases and norm weights
re-drawn at random (init leaves them at 0 and 1, which would hide a bias or
norm bug), carried across by ``models/convert.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.inference import paged_kv as jpk
from areal_tpu.models import qwen as jq
from areal_tpu_torch.inference import paged_kv as tpk
from areal_tpu_torch.models import convert
from areal_tpu_torch.models import qwen as tq

from tpu_testing import TINY_QWEN2, TINY_QWEN3

# f32 on the CPU: the same arithmetic with other summation orders
F32_TOL = dict(atol=2e-5, rtol=2e-5)


def port_cfg(jcfg, **over) -> tq.ModelConfig:
    names = {f.name for f in dataclasses.fields(tq.ModelConfig)}
    return tq.ModelConfig(**{**{k: v for k, v in jcfg.__dict__.items() if k in names}, **over})


def jax_params(jcfg, seed=0):
    """JAX init + random biases / norm weights, as numpy leaves."""
    p = jax.tree.map(np.asarray, jq.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for name, a in p["layers"].items():
        if name.endswith("norm"):
            p["layers"][name] = (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        elif name in ("bq", "bk", "bv"):
            p["layers"][name] = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    p["final_norm"] = (1.0 + 0.2 * rng.standard_normal(p["final_norm"].shape)).astype(
        p["final_norm"].dtype
    )
    return p


def port_model(jcfg, params):
    cfg = port_cfg(jcfg)
    model = tq.QwenModel(cfg, device="cpu")
    model.load_state_dict(convert.from_jax_params(params, cfg))
    return model


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("jcfg", [TINY_QWEN2, TINY_QWEN3], ids=["qwen2", "qwen3"])
def test_weight_bridge_round_trip(jcfg):
    params = jax_params(jcfg)
    cfg = port_cfg(jcfg)
    state = convert.from_jax_params(params, cfg)
    model = tq.QwenModel(cfg, device="cpu")
    model.load_state_dict(state)  # every port parameter is covered, no extras
    back = convert.to_jax_params(model.state_dict(), cfg)
    flat_a = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=str(k))


def test_weight_bridge_bf16_bits():
    jcfg = dataclasses.replace(TINY_QWEN2, dtype="bfloat16")
    params = jax.tree.map(np.asarray, jq.init_params(jax.random.PRNGKey(3), jcfg))
    state = convert.from_jax_params(params, port_cfg(jcfg))
    assert state["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        state["layers.1.wq"].float().numpy(), params["layers"]["wq"][1].astype(np.float32).T
    )


@pytest.mark.parametrize("jcfg", [TINY_QWEN2, TINY_QWEN3], ids=["qwen2-bias", "qwen3-qknorm"])
def test_forward_prefill_matches_jax(jcfg):
    params = jax_params(jcfg)
    model = port_model(jcfg, params)
    rng = np.random.default_rng(1)
    A, P = 3, 21
    ids = rng.integers(0, jcfg.vocab_size, (A, P)).astype(np.int32)
    pos = np.broadcast_to(np.arange(P, dtype=np.int32), (A, P)).copy()
    seg = (np.arange(P)[None] < np.array([[21], [9], [14]])).astype(np.int32)
    jh, jks, jvs = jq.forward_prefill(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(seg)
    )
    with torch.no_grad():
        th, tks, tvs = tq.forward_prefill(model, to_torch(ids), to_torch(pos), to_torch(seg))
        tl = tq.compute_logits(model, th)
    jl = jq.compute_logits(jax.tree.map(jnp.asarray, params), jcfg, jh)
    valid = seg.astype(bool)  # padded rows are discarded by every caller
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid], **F32_TOL)
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), **F32_TOL)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), **F32_TOL)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], **F32_TOL)


@pytest.mark.parametrize("kv", ["bfloat16", "int8", "fp8"])
@pytest.mark.parametrize("jcfg", [TINY_QWEN2, TINY_QWEN3], ids=["qwen2", "qwen3"])
def test_decode_step_matches_jax(jcfg, kv):
    """One forward_decode_paged step from the same random cache: hidden
    states and every cache leaf after the step's writes, f32 model."""
    params = jax_params(jcfg, seed=4)
    model = port_model(jcfg, params)
    rng = np.random.default_rng(5)
    S, psz, wp = 4, 8, 3
    N = S * wp + 1
    L, KH, hd = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim_
    ids = rng.integers(0, jcfg.vocab_size, S).astype(np.int32)
    positions = np.array([0, 7, 8, 20], np.int32)  # page edges and a later page
    pt = np.zeros((S, wp), np.int32)
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    for s in range(S):
        need = positions[s] // psz + 1
        pt[s, :need] = perm[s * wp : s * wp + need]
    raw_k = rng.standard_normal((L, KH, N, psz, hd)).astype(np.float32)
    raw_v = rng.standard_normal((L, KH, N, psz, hd)).astype(np.float32)
    if kv == "bfloat16":
        jcache = {"k": jnp.asarray(raw_k, jnp.bfloat16), "v": jnp.asarray(raw_v, jnp.bfloat16)}
    else:
        qd = jpk.quant_dtype(kv)
        k8, ks = jpk.quantize_kv(jnp.asarray(raw_k), qd)
        v8, vs = jpk.quantize_kv(jnp.asarray(raw_v), qd)
        jcache = {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
    tcache = {name: to_torch(a) for name, a in jcache.items()}
    jh, jc = jq.forward_decode_paged(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(ids), jnp.asarray(positions),
        dict(jcache), jnp.asarray(pt), page_size=psz, use_kernel=False,
    )
    with torch.no_grad():
        th, tc = tq.forward_decode_paged(
            model, to_torch(ids), to_torch(positions), tcache, to_torch(pt), page_size=psz
        )
    # bf16 pages: attention probabilities and values round to bf16 on both
    # sides at the same points, accumulated in other orders -> bf16-level
    tol = dict(atol=2e-2, rtol=2e-2) if kv == "bfloat16" else F32_TOL
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **tol)
    for name in jcache:
        want, got = as_f32(jc[name]), as_f32(tc[name])
        assert tc[name].dtype == tcache[name].dtype
        if name in ("k", "v") and kv == "int8":
            # rint of f32 values that differ in the last bit may move one step
            assert np.abs(got - want).max() <= 1, name
        elif name in ("k", "v") and kv == "fp8":
            np.testing.assert_allclose(got, want, rtol=2**-3, atol=0, err_msg=name)
        elif kv == "bfloat16":
            np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, **F32_TOL, err_msg=name)
    # the step wrote only the S rows it owns
    written = {(int(pt[s, positions[s] // psz]), int(positions[s] % psz)) for s in range(S)}
    before = as_f32(jcache["k"])
    after = as_f32(tc["k"])
    diff = np.argwhere((before != after).any(axis=-1))  # [layer, kh, page, row]
    assert {(int(p), int(r)) for _, _, p, r in diff} <= written
