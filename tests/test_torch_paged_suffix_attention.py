"""Kernel #3's plain version and the model paths around it against the JAX
package on the CPU.

The oracle is ``paged_suffix_attention_xla`` (the JAX package's exact-
semantics reference) and the JAX model paths with ``use_kernel=False``; the
interpret-mode Pallas kernel is not used (it needs ``pltpu.TPUCompilerParams``,
which the installed jax no longer has)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.inference import paged_kv as jpk
from areal_tpu.models import qwen as jq
from areal_tpu.ops.paged_suffix_attention import paged_suffix_attention_xla
from areal_tpu_torch.models import qwen as tq
from areal_tpu_torch.ops import paged_suffix_attention as psa

from test_torch_qwen import as_f32, jax_params, port_model, to_torch
from tpu_testing import TINY_QWEN2

# f32 on both sides: the same arithmetic summed in other orders
F32_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16 inputs and output: both sides compute in f32 and round the result to
# bf16 once; two results straddling a rounding boundary differ by one bf16
# step (2^-8 relative)
BF16_RTOL = 2**-7

# (H, KH): G = 1, 2, 6 (6 is Qwen2.5-1.5B's 12 / 2)
HEADS = {"G1": (2, 2), "G2": (4, 2), "G6": (12, 2)}
L, PSZ, WP, HD = 3, 8, 4, 16
LAYER = 2


def _chain_mask(S, B, lens):
    """Causal within each row's suffix; rows past its length have no bit."""
    m = np.tril(np.ones((B, B), bool))[None].repeat(S, 0)
    for s, n in enumerate(lens):
        m[s, n:, :] = False
        m[s, :, n:] = False
    return m


def _tree_mask(S, B, rng):
    """Ancestor-or-self masks of random trees rooted at row 0, plus one row
    whose diagonal bit is cleared while it keeps its ancestors: it must
    attend the suffix but not the prefix."""
    m = np.zeros((S, B, B), bool)
    for s in range(S):
        m[s, 0, 0] = True
        for j in range(1, B):
            p = int(rng.integers(0, j))
            m[s, j] = m[s, p]
            m[s, j, j] = True
    m[0, B - 1, B - 1] = False
    return m


def _inputs(H, KH, B, kind, seed=0):
    rng = np.random.default_rng(seed)
    S = 4
    N = S * WP + 1
    prefix_lens = np.array([0, 5, PSZ * 2, PSZ * WP], np.int32)
    pt = np.zeros((S, WP), np.int32)
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    for s in range(S):
        need = -(-int(prefix_lens[s]) // PSZ)
        pt[s, :need] = perm[s * WP : s * WP + need]
    pt[2, 0] = pt[3, 0]  # a shared page
    mask = _chain_mask(S, B, [B, B - 2, 1, 3]) if kind == "chain" else _tree_mask(S, B, rng)
    return dict(
        q=rng.standard_normal((S, B, H, HD)).astype(np.float32),
        ks=rng.standard_normal((S, B, KH, HD)).astype(np.float32),
        vs=rng.standard_normal((S, B, KH, HD)).astype(np.float32),
        kp=rng.standard_normal((L, KH, N, PSZ, HD)).astype(np.float32),
        vp=rng.standard_normal((L, KH, N, PSZ, HD)).astype(np.float32),
        plens=prefix_lens,
        pt=pt,
        mask=mask,
    )


@pytest.mark.parametrize("kind", ["chain", "tree"])
@pytest.mark.parametrize("pages", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("heads", list(HEADS))
def test_plain_matches_xla(heads, pages, kind):
    H, KH = HEADS[heads]
    x = _inputs(H, KH, 7, kind)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    dt = jnp.bfloat16 if pages == "bf16" else jnp.float32
    jq_, jks, jvs = (jx[n].astype(dt) for n in ("q", "ks", "vs"))
    scales = {}
    if pages in ("int8", "fp8"):
        qd = jpk.quant_dtype(pages)
        jkp, jksc = jpk.quantize_kv(jx["kp"], qd)
        jvp, jvsc = jpk.quantize_kv(jx["vp"], qd)
        scales = dict(k_scales=jksc, v_scales=jvsc)
    else:
        jkp, jvp = jx["kp"].astype(dt), jx["vp"].astype(dt)
    want = paged_suffix_attention_xla(
        jq_, jks, jvs, jkp, jvp, LAYER, jx["plens"], jx["pt"], jx["mask"], **scales
    )
    before = dict(psa.paged_suffix_attention.launches)
    got = psa.paged_suffix_attention(
        to_torch(jq_), to_torch(jks), to_torch(jvs), to_torch(jkp), to_torch(jvp), LAYER,
        to_torch(x["plens"]), to_torch(x["pt"]), torch.from_numpy(x["mask"]),
        **{k: to_torch(v) for k, v in scales.items()}, kind=kind,
    )
    assert psa.paged_suffix_attention.launches == before  # the CPU takes the plain version
    assert got.dtype == to_torch(jq_).dtype and tuple(got.shape) == tuple(want.shape)
    g, w = as_f32(got), as_f32(want)
    if pages == "bf16":
        assert (np.abs(g - w) <= BF16_RTOL * np.abs(w) + 1e-6).all()
    else:
        np.testing.assert_allclose(g, w, **F32_TOL)
    # rows with no valid bit: exact zeros on both sides
    dead = ~x["mask"].any(-1)
    assert dead.any() == (kind == "chain")
    assert not g[dead].any() and not w[dead].any()


def test_diagonal_gates_the_prefix():
    """A row with its diagonal bit clear attends only its suffix columns: the
    plain version then equals attention over the suffix alone."""
    H, KH = HEADS["G2"]
    x = _inputs(H, KH, 7, "tree", seed=3)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    out = psa.paged_suffix_attention_plain(
        t["q"], t["ks"], t["vs"], t["kp"], t["vp"], LAYER, t["plens"], t["pt"], t["mask"]
    )
    s, r = 0, 6  # the row _tree_mask cleared
    cols = x["mask"][s, r]
    qg = x["q"][s, r].reshape(KH, H // KH, HD)
    logits = np.einsum("kgd,tkd->kgt", qg, x["ks"][s][cols]) * HD**-0.5
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    ref = np.einsum("kgt,tkd->kgd", p, x["vs"][s][cols]).reshape(H, HD)
    np.testing.assert_allclose(out[s, r].numpy(), ref, **F32_TOL)


def _model_case(kv, seed):
    """A random stacked cache (bf16 / int8 / fp8 pages quantized by JAX), two
    slots' page tables over it, and the model weights on both sides."""
    jcfg = TINY_QWEN2
    params = jax_params(jcfg, seed=seed)
    model = port_model(jcfg, params)
    rng = np.random.default_rng(seed)
    Lc, KH, hd = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim_
    N = 12
    raw_k = rng.standard_normal((Lc, KH, N, PSZ, hd)).astype(np.float32)
    raw_v = rng.standard_normal((Lc, KH, N, PSZ, hd)).astype(np.float32)
    if kv == "none":
        jcache = {"k": jnp.asarray(raw_k), "v": jnp.asarray(raw_v)}
    else:
        qd = jpk.quant_dtype(kv)
        k8, ks = jpk.quantize_kv(jnp.asarray(raw_k), qd)
        v8, vs = jpk.quantize_kv(jnp.asarray(raw_v), qd)
        jcache = {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
    tcache = {n: to_torch(a) for n, a in jcache.items()}
    pt = np.array([[3, 7, 1, 0], [5, 2, 9, 11]], np.int32)
    return jcfg, params, model, rng, jcache, tcache, pt


@pytest.mark.parametrize("kv", ["none", "int8", "fp8"])
def test_forward_prefill_paged_matches_jax(kv):
    jcfg, params, model, rng, jcache, tcache, pt = _model_case(kv, seed=11)
    A, B = 2, 9
    plens = np.array([3 * PSZ, 2 * PSZ], np.int32)  # page-aligned cached prefixes
    sfx = np.array([9, 5])
    ids = rng.integers(0, jcfg.vocab_size, (A, B)).astype(np.int32)
    positions = (plens[:, None] + np.arange(B)[None]).astype(np.int32)
    seg = (np.arange(B)[None] < sfx[:, None]).astype(np.int32)
    jh, jks, jvs = jq.forward_prefill_paged(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(ids), jnp.asarray(positions),
        jnp.asarray(seg), dict(jcache), jnp.asarray(pt), jnp.asarray(plens), use_kernel=False,
    )
    with torch.no_grad():
        th, tks, tvs = tq.forward_prefill_paged(
            model, to_torch(ids), to_torch(positions), to_torch(seg), tcache, to_torch(pt),
            to_torch(plens),
        )
    valid = seg.astype(bool)  # padded rows go to the trash page on every path
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tks.numpy()[:, valid], np.asarray(jks)[:, valid], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tvs.numpy()[:, valid], np.asarray(jvs)[:, valid], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_forward_verify_paged_matches_jax(kv):
    from areal_tpu.inference import speculative as jspec
    from areal_tpu.api.config import SpeculativeConfig

    jcfg, params, model, rng, jcache, tcache, pt = _model_case(kv, seed=12)
    cfg = SpeculativeConfig(enabled=True, drafter="tree", spec_depth=3, tree_width=2, max_ngram=2)
    B = cfg.max_nodes()
    bundle = jspec.draft_batch(
        jspec.build_drafter(cfg), {0: [5, 8, 1, 5, 2, 6, 5], 1: [4, 4, 4, 4]}, 2, B - 1
    )
    assert bundle.n_draft.min() > 0
    pos0 = np.array([19, 3 * PSZ], np.int32)  # mid-page and page-aligned roots
    ids = np.concatenate([rng.integers(0, jcfg.vocab_size, (2, 1)), bundle.tokens], 1).astype(np.int32)
    depth = np.concatenate([np.zeros((2, 1), np.int32), bundle.depth], 1)
    positions = (pos0[:, None] + depth).astype(np.int32)
    jh, jks, jvs = jq.forward_verify_paged(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(ids), jnp.asarray(positions),
        jnp.asarray(bundle.mask), dict(jcache), jnp.asarray(pt), jnp.asarray(pos0), use_kernel=False,
    )
    with torch.no_grad():
        th, tks, tvs = tq.forward_verify_paged(
            model, to_torch(ids), to_torch(positions), torch.from_numpy(bundle.mask), tcache,
            to_torch(pt), to_torch(pos0),
        )
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), atol=2e-5, rtol=2e-5)
