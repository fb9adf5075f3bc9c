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


# ---------------------------------------------------------------------------
# split-KV: the kernel's split partials and merge, in plain PyTorch
# ---------------------------------------------------------------------------

# f32 on both sides; the splits' softmax is renormalised through exp(lse -
# max lse), which moves the last bits of f32 (2^-24 ~ 6e-8 relative) a few
# times over
SPLIT_RTOL = 1e-6
# 8 window tiles of psz * wp / TILE tokens: P = 3 leaves a ragged last split,
# P = 7 leaves splits 4..6 with no tile of the window
SPLIT_PSZ, SPLIT_WP = 16, 32
SPLIT_PLENS = [0, 1, SPLIT_PSZ, 100, 300, SPLIT_PSZ * SPLIT_WP]


def _split_case(kind, pages, seed=5):
    from areal_tpu_torch.inference import paged_kv as tpk

    rng = np.random.default_rng(seed)
    S, B, H, KH, hd, psz, wp = len(SPLIT_PLENS), 7, 12, 2, 16, SPLIT_PSZ, SPLIT_WP
    N = S * wp + 1
    plens = np.array(SPLIT_PLENS, np.int32)
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    pt = np.zeros((S, wp), np.int32)
    for s in range(S):
        need = -(-int(plens[s]) // psz)
        pt[s, :need] = perm[s * wp : s * wp + need]
    pt[3, 0] = pt[4, 0]  # a shared page
    mask = _chain_mask(S, B, [B, B - 3, 1, 2, B, 4]) if kind == "chain" else _tree_mask(S, B, rng)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    q, ks, vs = (t(rng.standard_normal(sh).astype(np.float32)) for sh in ((S, B, H, hd), (S, B, KH, hd), (S, B, KH, hd)))
    kp, vp = (t(rng.standard_normal((L, KH, N, psz, hd)).astype(np.float32)) for _ in range(2))
    sc = (None, None)
    if pages == "bf16":
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    else:
        qd = tpk.quant_dtype(pages)
        (kp, k_s), (vp, v_s) = tpk.quantize_kv(kp, qd), tpk.quantize_kv(vp, qd)
        sc = (k_s, v_s)
    return (q, ks, vs, kp, vp, LAYER, t(plens), t(pt), t(mask), *sc), (B, H // KH)


@pytest.mark.parametrize("pages", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("kind", ["chain", "tree"])
@pytest.mark.parametrize("n_splits", [1, 2, 3, 7])
def test_split_merge_matches_plain(n_splits, kind, pages):
    args, (B, G) = _split_case(kind, pages)
    parts = [psa._split_partials_plain(*args, n_splits=n_splits, split=p) for p in range(n_splits)]
    o_part = torch.stack([o for o, _ in parts])
    lse_part = torch.stack([lse for _, lse in parts])
    got = psa.merge_splits_plain(o_part, lse_part, B, G)
    want = psa.paged_suffix_attention_plain(*args)
    assert got.dtype == torch.float32 and got.shape == want.shape
    g, w = got.numpy(), want.numpy()
    np.testing.assert_allclose(g, w, rtol=SPLIT_RTOL, atol=SPLIT_RTOL * np.abs(w).max())
    mask = args[8].numpy()
    dead = ~mask.any(-1)  # rows with no valid bit: exact zeros
    assert dead.any() == (kind == "chain")
    assert not g[dead].any()
    plens, W = args[6].numpy(), SPLIT_PSZ * SPLIT_WP
    for p, (o, lse) in enumerate(parts):
        lo, hi = psa.split_tiles(SPLIT_WP, SPLIT_PSZ, n_splits, p)
        # a split with no tile of a slot's prefix (and no suffix) sees nothing there
        past = np.array([lo * psa.TILE >= min(n, W) for n in plens])
        if p > 0:
            assert torch.isneginf(lse[torch.from_numpy(past)]).all()
            assert not o[torch.from_numpy(past)].any()
        if n_splits == 7 and p >= 4:
            assert lo == hi  # a split past the window
        if p == n_splits - 1 > 0:
            assert past.any()  # the case is covered: some slot's prefix ends before the last split


def test_dropping_a_split_changes_the_result():
    """The merge reads every split: dropping the last one with finite lse
    moves the rows whose prefix reaches it."""
    args, (B, G) = _split_case("tree", "bf16")
    parts = [psa._split_partials_plain(*args, n_splits=3, split=p) for p in range(3)]
    o_part = torch.stack([o for o, _ in parts])
    lse_part = torch.stack([lse for _, lse in parts])
    last = max(p for p in range(3) if torch.isfinite(lse_part[p]).any())
    lse_part[last] = -torch.inf
    got = psa.merge_splits_plain(o_part, lse_part, B, G)
    want = psa.paged_suffix_attention_plain(*args)
    assert (got - want).abs().max() > 1e-2


# chip_smoke.py's kernel_suffix shapes: (S, KH, B, G, wp, psz)
PICK_SHAPES = {
    "warm-prefill-G6": (8, 2, 256, 6, 8, 128),
    "warm-prefill-G8": (8, 4, 256, 8, 8, 128),
    "verify-chain-G6": (32, 2, 5, 6, 16, 128),
    "verify-tree-G6": (32, 2, 9, 6, 16, 128),
    "verify-chain-G8": (32, 4, 5, 8, 16, 128),
    "verify-tree-G8": (32, 4, 9, 8, 16, 128),
}


@pytest.mark.parametrize("shape", list(PICK_SHAPES))
def test_pick_splits_from_shapes(shape):
    S, KH, B, G, wp, psz = PICK_SHAPES[shape]
    n = psa.pick_splits(S, KH, B, G, wp, psz, 132)  # an H100's 132 SMs
    assert isinstance(n, int) and n == psa.pick_splits(S, KH, B, G, wp, psz, 132)
    assert (n == 1) if shape.startswith("warm") else (1 < n <= psa.MAX_SPLITS)
    # the splits cover the window's tiles once each, none of them empty
    spans = [psa.split_tiles(wp, psz, n, p) for p in range(n)]
    assert spans[0][0] == 0 and spans[-1][1] == -(-wp * psz // psa.TILE)
    assert all(lo < hi for lo, hi in spans) and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def _wrapper_case():
    S, B, H, KH, hd, psz, wp = 2, 3, 4, 2, 64, 16, 2
    z = lambda *sh, dt=torch.bfloat16: torch.zeros(sh, dtype=dt)  # noqa: E731
    return dict(q=z(S, B, H, hd), k_suffix=z(S, B, KH, hd), v_suffix=z(S, B, KH, hd),
                k_pages=z(2, KH, 5, psz, hd), v_pages=z(2, KH, 5, psz, hd), layer=1,
                prefix_lens=z(S, dt=torch.int32), page_indices=z(S, wp, dt=torch.int32),
                suffix_mask=z(S, B, B, dt=torch.bool), k_scales=None, v_scales=None)


BAD_ARGS = {
    "f32 q": dict(q=torch.zeros(2, 3, 4, 64)),
    "int64 prefix_lens": dict(prefix_lens=torch.zeros(2, dtype=torch.int64)),
    "int mask": dict(suffix_mask=torch.zeros(2, 3, 3, dtype=torch.int32)),
    "int8 pages without scales": dict(k_pages=torch.zeros(2, 2, 5, 16, 64, dtype=torch.int8),
                                      v_pages=torch.zeros(2, 2, 5, 16, 64, dtype=torch.int8)),
    "layer out of range": dict(layer=2),
    "head_dim 32": dict(q=torch.zeros(2, 3, 4, 32, dtype=torch.bfloat16)),
}


@pytest.mark.parametrize("bad", list(BAD_ARGS))
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """The wrapper's checks run before any launch (the kernel reads raw
    pointers); they are plain Python, so they hold here too."""
    good = _wrapper_case()
    psa._check_cuda_args(**good)  # the good case passes
    with pytest.raises((TypeError, ValueError)):
        psa._check_cuda_args(**{**good, **BAD_ARGS[bad]})
