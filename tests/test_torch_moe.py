"""The port's MoE pieces against the JAX package on the CPU: the grouped
matmul's plain version against megablox ``gmm`` in interpret mode, the
router, the dropless and capacity ``moe_ffn`` (out and aux), the HF config
reader and the weight bridge.

Inputs are made with numpy from a seed and handed to both sides. The JAX
grouped matmul runs as the JAX package runs it off a TPU: megablox in
interpret mode with the tiling ``areal_tpu/models/moe.py:197-200`` picks."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.megablox import gmm as megablox_gmm

from areal_tpu.models import moe as jmoe
from areal_tpu.models import qwen as jq
from areal_tpu_torch.models import convert
from areal_tpu_torch.models import moe as tmoe
from areal_tpu_torch.models import qwen as tq
from areal_tpu_torch.ops.gmm import gmm, gmm_plain

from test_torch_qwen import port_cfg, to_torch

# f32 on both sides: the same products, summed in other orders
F32_TOL = dict(atol=1e-5, rtol=1e-5)

MOE_CFG = jq.ModelConfig(
    vocab_size=256,
    hidden_size=32,
    intermediate_size=64,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    dtype="float32",
    tie_word_embeddings=False,
    attention_bias=False,
    qk_norm=True,
    num_experts=8,
    num_experts_per_tok=2,
    moe_intermediate_size=24,
)

# Qwen3-30B-A3B's config.json (huggingface.co/Qwen/Qwen3-30B-A3B), the
# fields the model reads
QWEN3_30B_A3B = {
    "architectures": ["Qwen3MoeForCausalLM"],
    "model_type": "qwen3_moe",
    "vocab_size": 151936,
    "hidden_size": 2048,
    "intermediate_size": 6144,
    "num_hidden_layers": 48,
    "num_attention_heads": 32,
    "num_key_value_heads": 4,
    "head_dim": 128,
    "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-06,
    "tie_word_embeddings": False,
    "attention_bias": False,
    "num_experts": 128,
    "num_experts_per_tok": 8,
    "moe_intermediate_size": 768,
    "norm_topk_prob": True,
    "decoder_sparse_step": 1,
    "torch_dtype": "bfloat16",
}


def _jax_gmm(lhs, rhs, sizes):
    """megablox gmm as the JAX MoE calls it off a TPU."""
    tm = math.gcd(lhs.shape[0], 16)
    return np.asarray(
        megablox_gmm(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(sizes, jnp.int32),
                     tiling=(tm, 128, 128), interpret=True)
    )


GMM_CASES = {
    # M, k, n, group sizes
    "ragged-empty-groups": (40, 32, 24, [7, 0, 13, 1, 0, 15]),  # 36 rows: 4 past the groups
    "one-group-odd-M": (37, 16, 40, [0, 0, 37, 0]),
    "single-rows": (12, 24, 16, [1, 1, 0, 1, 9]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(GMM_CASES))
def test_gmm_plain_matches_megablox(case, dtype):
    """Rows inside the groups: the same f32 products of the same inputs
    (bf16 inputs are exact in f32), summed in other orders. Rows past
    sum(group_sizes): megablox leaves them uninitialized, the port writes
    zeros."""
    M, k, n, sizes = GMM_CASES[case]
    rng = np.random.default_rng(0)
    lhs = jnp.asarray(rng.standard_normal((M, k)), dtype)
    rhs = jnp.asarray(rng.standard_normal((len(sizes), k, n)), dtype)
    want = _jax_gmm(lhs, rhs, sizes)
    got = gmm(to_torch(lhs), to_torch(rhs), torch.tensor(sizes, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.shape == (M, n)
    used = sum(sizes)
    np.testing.assert_allclose(got.numpy()[:used], want[:used], **F32_TOL)
    assert torch.count_nonzero(got[used:]) == 0


def test_gmm_plain_is_differentiable():
    """On the CPU the plain version carries gradients through autograd of its
    own ops (the wrapper's backward goes through ``GroupedMatmul`` and the
    plain backward functions, ``tests/test_torch_gmm_bwd.py``)."""
    lhs = torch.randn(10, 8, requires_grad=True)
    rhs = torch.randn(3, 8, 16, requires_grad=True)
    gmm_plain(lhs, rhs, torch.tensor([4, 0, 5], dtype=torch.int32)).sum().backward()
    assert lhs.grad[9].abs().sum() == 0 and lhs.grad[:9].abs().sum() > 0
    assert rhs.grad[1].abs().sum() == 0


def _layer(cfg, seed, dtype="float32"):
    """Layer 0 of the JAX init (numpy leaves) in ``dtype``, and its port
    twin (the MoE leaves keep JAX's layout: no transposes)."""
    jcfg = dataclasses.replace(cfg, dtype=dtype)
    p = jax.tree.map(lambda x: np.asarray(x[0]), jq.init_params(jax.random.PRNGKey(seed), jcfg)["layers"])
    names = ("w_router", "we_gate", "we_up", "we_down")
    return jcfg, {n: jnp.asarray(p[n]) for n in names}, SimpleLayer({n: to_torch(p[n]) for n in names})


class SimpleLayer:
    def __init__(self, d):
        self.__dict__.update(d)


def _hidden(shape, seed, dtype, imbalanced=False):
    rng = np.random.default_rng(seed)
    if imbalanced:  # near-identical tokens: every token routes to the same experts
        h = rng.normal(0, 1, shape[-1])[None, None] + 0.01 * rng.normal(0, 1, shape)
    else:
        h = rng.normal(0, 1, shape)
    return jnp.asarray(h, dtype)


def test_router_matches_jax():
    jcfg, jl, tl = _layer(MOE_CFG, 0)
    h = np.asarray(_hidden((24, 32), 1, "float32"))
    jp, jtp, jte = jmoe._router(jnp.asarray(h), jl["w_router"], 2, True)
    tp, ttp, tte = tmoe._router(to_torch(h), tl.w_router, 2, True)
    np.testing.assert_array_equal(tte.numpy(), np.asarray(jte))
    np.testing.assert_allclose(ttp.numpy(), np.asarray(jtp), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6, rtol=0)


def _assert_bf16_close(got: torch.Tensor, want, max_mismatch: float):
    """bf16 outputs whose every rounding point matches: each element equal
    or one bf16 step apart (f32 sums in other orders can straddle a rounding
    boundary), and at most ``max_mismatch`` of them apart at all."""
    g, w = got.float().numpy(), np.asarray(jnp.asarray(want).astype(jnp.float32))
    step = np.maximum(np.abs(w), 1e-30) * 2**-7
    assert (np.abs(g - w) <= step).all(), np.abs(g - w).max()
    assert (g != w).mean() <= max_mismatch, (g != w).mean()


@pytest.mark.parametrize(
    "dtype,imbalanced",
    [("float32", False), ("float32", True), ("bfloat16", False)],
    ids=["f32", "f32-imbalanced", "bf16"],
)
@pytest.mark.parametrize("dropless", [True, False], ids=["dropless", "capacity"])
def test_moe_ffn_matches_jax(dropless, dtype, imbalanced):
    """``moe_ffn`` out and aux against JAX at the same [G, L, D] (capacity
    routing depends on the layout). The imbalanced case sends every token to
    the same experts: dropless computes them all, capacity drops the
    overflow, on both sides alike. bf16 holds the dropless path's rounding
    points."""
    cfg = dataclasses.replace(MOE_CFG, moe_dropless=dropless, capacity_factor=1.0)
    jcfg, jl, tl = _layer(cfg, 2, dtype)
    h = _hidden((2, 16, 32), 3, dtype, imbalanced)
    jout, jaux = jmoe.moe_ffn(h, jl, jcfg)
    tout, taux = tmoe.moe_ffn(to_torch(h), tl, port_cfg(jcfg), with_aux=True)
    assert tout.dtype == to_torch(h).dtype and tout.shape == h.shape
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32_TOL)
    elif dropless:
        _assert_bf16_close(tout, jout, max_mismatch=0.02)
    else:
        # the capacity path rounds to bf16 after every einsum and inside
        # silu, and XLA's bf16 logistic rounds a third of its elements one
        # step away from torch's sigmoid: a few bf16 steps of noise
        g, w = tout.float().numpy(), np.asarray(jout.astype(jnp.float32))
        rms = np.sqrt((w**2).mean())
        assert (np.abs(g - w) <= 2**-6 * np.abs(w) + 2**-4 * rms).all()
    if dropless and imbalanced:
        assert (tout.abs().sum(-1) > 1e-7).all()  # nothing dropped
    if not dropless and imbalanced:
        assert (tout.abs().sum(-1) == 0).any()  # the overflow is dropped
    _, none = tmoe.moe_ffn(to_torch(h), tl, port_cfg(jcfg))
    assert none is None  # the serving paths skip the aux


def test_bf16_rounding_points_are_pinned():
    """The bf16 check above tells the rounding points apart: the port's
    dispatch with ``silu(g1) * u1`` left in f32 (one rounding point
    skipped) misses it."""
    jcfg, jl, tl = _layer(MOE_CFG, 2, "bfloat16")
    h = _hidden((2, 16, 32), 3, "bfloat16")
    jout, _ = jmoe.moe_ffn(h, jl, jcfg)
    x = to_torch(h).reshape(-1, 32)
    _, top_p, top_e = tmoe._router(x.float(), tl.w_router, 2, True)
    order = torch.argsort(top_e.reshape(-1), stable=True)
    sizes = torch.bincount(top_e.reshape(-1), minlength=8).to(torch.int32)
    xs = x.index_select(0, order // 2)
    y = torch.nn.functional.silu(gmm_plain(xs, tl.we_gate, sizes)) * gmm_plain(xs, tl.we_up, sizes)
    yd = gmm_plain(y, tl.we_down.float(), sizes)  # y not rounded to bf16
    out = (yd[torch.argsort(order)].view(-1, 2, 32) * top_p[:, :, None]).sum(1)
    with pytest.raises(AssertionError):
        _assert_bf16_close(out.reshape(2, 16, 32).bfloat16(), jout, max_mismatch=0.02)


def test_from_hf_dict_matches_jax():
    names = {f.name for f in dataclasses.fields(tq.ModelConfig)}
    for d in (QWEN3_30B_A3B, {**QWEN3_30B_A3B, "model_type": "qwen3", "num_experts": 0}):
        got, want = tq.ModelConfig.from_hf_dict(d), jq.ModelConfig.from_hf_dict(d)
        assert {n: getattr(got, n) for n in names} == {n: getattr(want, n) for n in names if hasattr(want, n)}
    got = tq.ModelConfig.from_hf_dict(QWEN3_30B_A3B)
    assert (got.num_experts, got.num_experts_per_tok, got.moe_intermediate_size) == (128, 8, 768)
    assert (got.q_dim, got.hidden_size, got.qk_norm, got.attention_bias) == (4096, 2048, True, False)
    qwen2_moe = {**QWEN3_30B_A3B, "model_type": "qwen2_moe"}
    with pytest.raises(ValueError, match="SHARED experts"):
        jq.ModelConfig.from_hf_dict(qwen2_moe)
    with pytest.raises(ValueError, match="SHARED experts"):
        tq.ModelConfig.from_hf_dict(qwen2_moe)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_bridge_round_trip_moe(dtype):
    """The MoE leaves cross both ways unchanged (no transposes), exactly."""
    jcfg = dataclasses.replace(MOE_CFG, dtype=dtype)
    params = jax.tree.map(np.asarray, jq.init_params(jax.random.PRNGKey(5), jcfg))
    cfg = port_cfg(jcfg)
    model = tq.QwenModel(cfg, device="cpu")
    model.load_state_dict(convert.from_jax_params(params, cfg))  # every leaf covered, no extras
    assert "w_gate" not in dict(model.named_parameters()) and model.layers[1].we_down.shape == (8, 24, 32)
    back = convert.to_jax_params(model.state_dict(), cfg)
    flat_a = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_a[k], np.float32), flat_b[k], err_msg=str(k))


def test_init_params_fills_the_moe_leaves():
    cfg = port_cfg(MOE_CFG)
    model = tq.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    w = model.layers[0].we_gate
    assert w.shape == (8, 32, 24) and 0.015 < w.std().item() < 0.025 and w.abs().max().item() <= 0.04
    assert model.layers[1].w_router.abs().sum() > 0
