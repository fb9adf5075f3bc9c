"""The port's tree attention against the JAX package on the CPU: the packed
ancestor bits (identical), the plain versions of kernels #4-#6 against
``areal_tpu/ops/tree_attention.py``'s Pallas kernels in interpret mode,
the autograd wrapper against the dense masked softmax, and the model over a
packed forest against ``forest_hidden`` / ``tree_forward_logprobs_pallas``
on a 2-layer model with the same weights (``models/convert.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.models import tree as jtree
from areal_tpu.ops import tree_attention as jta
from areal_tpu_torch.models import convert
from areal_tpu_torch.models import qwen as tq
from areal_tpu_torch.models import tree as ttree
from areal_tpu_torch.ops import tree_attention as tta

from test_torch_qwen import jax_params, port_cfg
from tpu_testing import TINY_QWEN2

# f32 on both sides: the same products summed in other orders
OUT_ATOL = 1e-5  # attention outputs and logsumexp, O(1) values
GRAD_RTOL = 1e-4  # gradients, relative to the largest entry
LOGP_ATOL = 5e-5  # logprobs through a 2-layer model (test_torch_train_engine's)


def _forest(seed=0, groups=((130, 3, 30), (110, 3, 25)), vocab=50):
    """Tries of GRPO groups: each (prompt length, samples, max response
    length) shares one prompt; two groups give disjoint tries, so the skip
    map has zero tiles below the diagonal."""
    rng = np.random.default_rng(seed)
    seqs = []
    for plen, n, rmax in groups:
        prompt = rng.integers(0, vocab, plen).tolist()
        seqs += [prompt + rng.integers(0, vocab, int(rng.integers(3, rmax))).tolist() for _ in range(n)]
    return seqs


def _agentic(seed=1, n=300, vocab=50):
    """A deep trie branching at several depths: each sequence extends a
    random prefix of an earlier one."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, vocab, 60).tolist()]
    while sum(len(s) for s in seqs) < n * 3:
        base = seqs[int(rng.integers(0, len(seqs)))]
        cut = int(rng.integers(1, len(base)))
        seqs.append(base[:cut] + rng.integers(0, vocab, int(rng.integers(5, 40))).tolist())
    return seqs


TRIES = {"grpo-forest": _forest, "agentic": _agentic}


def _bits(seqs, n_pad=None):
    pack = jtree.build_tree(seqs)
    n_pad = n_pad or -(-pack.n_nodes // jta.BLOCK) * jta.BLOCK
    return pack, jta.pack_ancestor_bits(pack.parent, n_pad)


@pytest.mark.parametrize("trie", list(TRIES))
@pytest.mark.parametrize("extra_pad", [0, 128], ids=["tight", "padded"])
def test_pack_ancestor_bits_identical(trie, extra_pad):
    pack = jtree.build_tree(TRIES[trie]())
    n_pad = -(-pack.n_nodes // 128) * 128 + extra_pad
    want_w, want_b = jta.pack_ancestor_bits(pack.parent, n_pad)
    got_w, got_b = tta.pack_ancestor_bits(pack.parent, n_pad)
    assert got_w.dtype == np.uint32 and got_b.dtype == np.int32
    np.testing.assert_array_equal(got_w, want_w)
    np.testing.assert_array_equal(got_b, want_b)
    assert (got_w >> np.uint32(31) & 1).any()  # bit 31 is live
    assert not got_w[pack.n_nodes :].any()  # padded rows carry no bit
    # the int32 view expands to the trie's ancestor mask
    mask = tta.expand_mask(torch.from_numpy(got_w.view(np.int32))).numpy()
    np.testing.assert_array_equal(mask[: pack.n_nodes, : pack.n_nodes], pack.ancestor_mask())
    assert not mask[pack.n_nodes :].any() and not mask[:, pack.n_nodes :].any()


def test_forest_skip_map_has_zero_tiles_below_the_diagonal():
    pack = jtree.build_tree(_forest())
    _, block_any = tta.pack_ancestor_bits(pack.parent)
    below = np.tril(np.ones_like(block_any), -1).astype(bool)
    assert (block_any[below] == 0).any() and (block_any[below] == 1).any()
    assert not np.triu(block_any, 1).any()


def _qkv(N, H, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((N, H, d)).astype(np.float32) for _ in range(4)]


def _valid(words):
    return tta.expand_mask(torch.from_numpy(words.view(np.int32))).any(-1).numpy()


@pytest.mark.parametrize("trie", list(TRIES))
def test_plain_forward_matches_jax_interpret_kernel(trie):
    pack, (words, block_any) = _bits(TRIES[trie]())
    N, H, d = words.shape[0], 2, 64
    q, k, v, _ = _qkv(N, H, d)
    want_o, want_lse = jta._fwd_pallas(*map(jnp.asarray, (q, k, v, words, block_any)), interpret=True)
    got_o, got_lse = tta.tree_attention_fwd_plain(
        *map(torch.from_numpy, (q, k, v, words.view(np.int32), block_any))
    )
    valid = _valid(words)
    assert valid.sum() == pack.n_nodes
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=OUT_ATOL)
    assert not got_o.numpy()[~valid].any() and not got_lse.numpy()[~valid].any()
    # JAX writes about -1e30 on padded rows; compare valid rows only
    np.testing.assert_allclose(got_lse.numpy()[valid], np.asarray(want_lse).T[valid], atol=OUT_ATOL)


@pytest.mark.parametrize("trie", list(TRIES))
def test_plain_backward_matches_jax_vjp(trie):
    _, (words, block_any) = _bits(TRIES[trie]())
    N, H, d = words.shape[0], 2, 64
    q, k, v, dout = _qkv(N, H, d, seed=2)
    valid = _valid(words)
    dout[~valid] = 0.0  # the loss gives padded rows no gradient

    def f(q_, k_, v_):
        return jta.tree_attention(q_, k_, v_, jnp.asarray(words), jnp.asarray(block_any), True)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq_, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    tw, tb = torch.from_numpy(words.view(np.int32)), torch.from_numpy(block_any)
    out, lse = tta.tree_attention_fwd_plain(tq_, tk, tv, tw, tb)
    delta = (tdo * out).sum(-1)
    got = tta.tree_attention_bwd_plain(tq_, tk, tv, tw, tb, tdo, lse, delta)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_RTOL * np.abs(w).max(), err_msg=name)
    # the wrappers on CPU tensors are the plain versions, and launch nothing
    launches = [w.launches for w in (tta.tree_attention_bwd_dq, tta.tree_attention_bwd_dkv)]
    assert torch.equal(tta.tree_attention_bwd_dq(tq_, tk, tv, tw, tb, tdo, lse, delta), got[0])
    dk, dv = tta.tree_attention_bwd_dkv(tq_, tk, tv, tw, tb, tdo, lse, delta)
    assert torch.equal(dk, got[1]) and torch.equal(dv, got[2])
    assert [w.launches for w in (tta.tree_attention_bwd_dq, tta.tree_attention_bwd_dkv)] == launches


def test_autograd_matches_dense_masked_softmax():
    pack, (words, block_any) = _bits(_agentic(seed=3))
    N, H, d = words.shape[0], 3, 64
    q, k, v, dout = (torch.from_numpy(x) for x in _qkv(N, H, d, seed=4))
    valid = torch.from_numpy(_valid(words))
    dout = dout * valid[:, None, None]
    tw, tb = torch.from_numpy(words.view(np.int32)), torch.from_numpy(block_any)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tta.tree_attention(*leaves, tw, tb)
    (out * dout).sum().backward()
    ref_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    mask = torch.zeros((N, N), dtype=torch.bool)
    mask[: pack.n_nodes, : pack.n_nodes] = torch.from_numpy(pack.ancestor_mask())
    logits = torch.einsum("qhd,khd->hqk", ref_leaves[0], ref_leaves[1]) * d**-0.5
    probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1).nan_to_num(0.0)
    ref = torch.einsum("hqk,khd->qhd", probs, ref_leaves[2])
    (ref * dout).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=OUT_ATOL)
    for a, b in zip(leaves, ref_leaves):
        scale = b.grad.abs().max().item()
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=GRAD_RTOL * scale)


# ---------------------------------------------------------------------------
# the backward kernels' walk over 64-row tile pairs
# ---------------------------------------------------------------------------


def _chain(n=300, vocab=50):
    """One sequence: every node attends all earlier ones."""
    return [np.random.default_rng(8).integers(0, vocab, n).tolist()]


def _grpo_offset(vocab=50):
    """Two GRPO groups whose prompts (100 and 70 tokens) and branches end
    off the 64-row tile edges."""
    rng = np.random.default_rng(9)
    seqs = []
    for plen, n, blen in ((100, 4, 90), (70, 3, 50)):
        prompt = rng.integers(0, vocab, plen).tolist()
        seqs += [prompt + rng.integers(0, vocab, blen).tolist() for _ in range(n)]
    return seqs


def _agentic_deep(vocab=50):
    """Agent episodes over one 150-token system prompt: each trajectory
    forks from an earlier one at a random depth past the prompt."""
    rng = np.random.default_rng(10)
    seqs = [rng.integers(0, vocab, 190).tolist()]
    while sum(len(s) for s in seqs) < 1500:
        base = seqs[int(rng.integers(0, len(seqs)))]
        cut = int(rng.integers(150, len(base)))
        seqs.append(base[:cut] + rng.integers(0, vocab, int(rng.integers(10, 60))).tolist())
    return seqs


# (sequences, padding rows past the last 128-row bucket)
TILE_TRIES = {
    "chain": (_chain, 0),
    "grpo-offset": (_grpo_offset, 0),
    "agentic-deep": (_agentic_deep, 0),
    "grpo-offset-padded": (_grpo_offset, 256),
}


def _tile_bits(trie):
    seqs, extra = TILE_TRIES[trie]
    pack = jtree.build_tree(seqs())
    return pack, jta.pack_ancestor_bits(pack.parent, -(-pack.n_nodes // jta.BLOCK) * jta.BLOCK + extra)


def _brute_classes(words, tile=64):
    """Every tile pair's class from the expanded bits, one pair at a time."""
    N = words.shape[0]
    mask = np.unpackbits(words.astype("<u4").view(np.uint8), bitorder="little").reshape(N, N).astype(bool)
    assert not np.triu(mask, 1).any()  # parent before child
    nt = N // tile
    out = np.zeros((nt, nt), np.int32)
    for qt in range(nt):
        for kt in range(qt + 1):
            m = mask[qt * tile : (qt + 1) * tile, kt * tile : (kt + 1) * tile]
            out[qt, kt] = tta.FULL if m.all() else tta.PARTIAL if m.any() else tta.DEAD
    return out


@pytest.mark.parametrize("trie", list(TILE_TRIES))
def test_tree_tile_classes_match_brute_force(trie):
    pack, (words, _) = _tile_bits(trie)
    want = _brute_classes(words)
    got = tta.tree_tile_classes(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got, want)
    lower = want[np.tril_indices(want.shape[0])]
    # every trie shows all three classes on or below the diagonal
    assert {tta.DEAD, tta.PARTIAL, tta.FULL} <= set(lower.tolist()), np.bincount(lower)
    if pack.n_nodes % 64:  # the tile holding the last node and padding rows is never full
        assert (want[pack.n_nodes // 64] != tta.FULL).all()
    assert (want[-(-pack.n_nodes // 64) :] == tta.DEAD).all()  # padding-only query tiles


def _tiled_fwd(q, k, v, words, tile=64):
    """#4's walk in plain torch: each query tile takes its live key tiles
    in order, full pairs without the mask, partial pairs with it, dead
    pairs never touched, and keeps a running max, a running sum and an f32
    O per row, normalised once at the end. Returns f32 (out [N, H, d], lse
    [N, H]), rows with no bit zero."""
    N, H, d = q.shape
    scale = d**-0.5
    classes = tta.tree_tile_classes(words, tile)
    mask = tta.expand_mask(words)
    out, lse = torch.zeros((N, H, d)), torch.zeros((N, H))
    rows = [slice(t * tile, (t + 1) * tile) for t in range(N // tile)]
    for qt, qs in enumerate(rows):
        m = torch.full((H, tile), -torch.inf)
        l, o = torch.zeros((H, tile)), torch.zeros((H, tile, d))
        for kt in np.flatnonzero(classes[qt]):
            s = torch.einsum("qhd,khd->hqk", q[qs], k[rows[kt]]) * scale
            if classes[qt, kt] != tta.FULL:
                s = torch.where(mask[qs, rows[kt]], s, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1))
            msub = torch.where(m_new == -torch.inf, 0.0, m_new)  # a row with no bit yet
            alpha = torch.exp(m - msub)
            p = torch.exp(s - msub[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum("hqk,khd->hqd", p, v[rows[kt]])
            m = m_new
        live = l > 0
        out[qs] = torch.where(live[..., None], o / l[..., None], 0.0).transpose(0, 1)
        lse[qs] = torch.where(live, m + torch.log(l), 0.0).t()
    return out, lse


@pytest.mark.parametrize("trie", list(TILE_TRIES))
def test_tiled_fwd_walk_matches_plain_and_jax_interpret(trie):
    _, (words, block_any) = _tile_bits(trie)
    N, H, d = words.shape[0], 2, 64
    q, k, v, _ = _qkv(N, H, d, seed=14)
    valid = _valid(words)
    tw, tb = torch.from_numpy(words.view(np.int32)), torch.from_numpy(block_any)
    got_o, got_lse = _tiled_fwd(*map(torch.from_numpy, (q, k, v)), tw)
    plain_o, plain_lse = tta.tree_attention_fwd_plain(*map(torch.from_numpy, (q, k, v)), tw, tb)
    want_o, want_lse = jta._fwd_pallas(*map(jnp.asarray, (q, k, v, words, block_any)), interpret=True)
    for name, g, p_ in (("out", got_o, plain_o), ("lse", got_lse, plain_lse)):
        # the same f32 products summed tile by tile: f32 rounding only
        np.testing.assert_allclose(g.numpy(), p_.numpy(), atol=1e-6 * p_.abs().max().item(), err_msg=name)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=OUT_ATOL)
    # JAX writes about -1e30 on padded rows; compare valid rows only
    np.testing.assert_allclose(got_lse.numpy()[valid], np.asarray(want_lse).T[valid], atol=OUT_ATOL)
    assert not got_o.numpy()[~valid].any() and not got_lse.numpy()[~valid].any()  # padding rows: exact zeros


def _tiled_bwd(q, k, v, words, dout, lse, delta, tile=64):
    """The kernels' walk in plain torch: #5 takes each query tile's live key
    tiles in order, #6 each key tile's live query tiles; full pairs run
    without the mask, partial pairs with it, dead pairs are never touched.
    Returns f32 (dq, dk, dv)."""
    N, H, d = q.shape
    scale = d**-0.5
    classes = tta.tree_tile_classes(words, tile)
    mask = tta.expand_mask(words)

    def pair(qs, ks, full):
        s = torch.einsum("qhd,khd->hqk", q[qs], k[ks]) * scale
        p = torch.exp(s - lse[qs].t()[..., None])
        if not full:
            p = torch.where(mask[qs, ks], p, 0.0)
        dp = torch.einsum("qhd,khd->hqk", dout[qs], v[ks])
        return p, p * (dp - delta[qs].t()[..., None])

    dq, dk, dv = (torch.zeros((N, H, d)) for _ in range(3))
    nt = N // tile
    rows = [slice(t * tile, (t + 1) * tile) for t in range(nt)]
    for qt in range(nt):  # #5
        for kt in np.flatnonzero(classes[qt]):
            _, ds = pair(rows[qt], rows[kt], classes[qt, kt] == tta.FULL)
            dq[rows[qt]] += torch.einsum("hqk,khd->qhd", ds, k[rows[kt]])
    for kt in range(nt):  # #6
        for qt in np.flatnonzero(classes[:, kt]):
            p, ds = pair(rows[qt], rows[kt], classes[qt, kt] == tta.FULL)
            dv[rows[kt]] += torch.einsum("hqk,qhd->khd", p, dout[rows[qt]])
            dk[rows[kt]] += torch.einsum("hqk,qhd->khd", ds, q[rows[qt]])
    return dq * scale, dk * scale, dv


@pytest.mark.parametrize("trie", list(TILE_TRIES))
def test_tiled_walk_matches_plain_backward_and_jax_vjp(trie):
    _, (words, block_any) = _tile_bits(trie)
    N, H, d = words.shape[0], 2, 64
    q, k, v, dout = _qkv(N, H, d, seed=11)
    valid = _valid(words)
    dout[~valid] = 0.0
    tq_, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    tw, tb = torch.from_numpy(words.view(np.int32)), torch.from_numpy(block_any)
    out, lse = tta.tree_attention_fwd_plain(tq_, tk, tv, tw, tb)
    delta = (tdo * out).sum(-1)
    got = _tiled_bwd(tq_, tk, tv, tw, tdo, lse, delta)
    plain = tta.tree_attention_bwd_plain(tq_, tk, tv, tw, tb, tdo, lse, delta)

    def f(q_, k_, v_):
        return jta.tree_attention(q_, k_, v_, jnp.asarray(words), jnp.asarray(block_any), True)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    for name, g, p_, w in zip(("dq", "dk", "dv"), got, plain, vjp(jnp.asarray(dout))):
        # the same f32 products summed tile by tile: f32 rounding only
        np.testing.assert_allclose(g.numpy(), p_.numpy(), atol=1e-6 * p_.abs().max().item(), err_msg=name)
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_RTOL * np.abs(w).max(), err_msg=name)
        assert not g.numpy()[~valid].any()  # padding rows: exact zeros


# ---------------------------------------------------------------------------
# the model over a packed forest
# ---------------------------------------------------------------------------


def _models(seed=0):
    params = jax_params(TINY_QWEN2, seed=seed)
    cfg = port_cfg(TINY_QWEN2, remat=False)
    model = tq.QwenModel(cfg, device="cpu")
    model.load_state_dict(convert.from_jax_params(params, cfg))
    return jax.tree.map(jnp.asarray, params), model


def test_forest_hidden_matches_jax():
    params, model = _models()
    pack, (words, block_any) = _bits(_forest(seed=5, vocab=TINY_QWEN2.vocab_size))
    n_pad = words.shape[0]
    ids = np.zeros(n_pad, np.int32)
    ids[: pack.n_nodes] = pack.tokens
    pos = np.zeros(n_pad, np.int32)
    pos[: pack.n_nodes] = pack.depth
    want = jta.forest_hidden(params, TINY_QWEN2, *map(jnp.asarray, (ids, pos, words, block_any)), remat=False)
    with torch.no_grad():
        got = tta.forest_hidden(model, *map(torch.from_numpy, (ids.astype(np.int64), pos.astype(np.int64),
                                                               words.view(np.int32), block_any)))
    n = pack.n_nodes  # padded rows attend nothing; their hidden states are not read
    np.testing.assert_allclose(got.numpy()[:n], np.asarray(want)[:n], atol=OUT_ATOL * 10)


@pytest.mark.parametrize("impl", ["sparse", "dense"])
def test_tree_train_logprobs_match_jax(impl):
    params, model = _models(seed=1)
    seqs = _agentic(seed=6, n=150, vocab=TINY_QWEN2.vocab_size)
    tpack, jpack = ttree.build_tree(seqs), jtree.build_tree(seqs)
    want = np.asarray(jtree.tree_train_logprobs(params, TINY_QWEN2, jpack, impl=impl))
    with torch.no_grad():
        got = ttree.tree_train_logprobs(model, tpack, impl=impl).numpy()
    np.testing.assert_allclose(got, want, atol=LOGP_ATOL)
    assert got[tpack.parent < 0].tolist() == [0.0] * int((tpack.parent < 0).sum())
    if impl == "sparse":
        np.testing.assert_allclose(
            tta.tree_forward_logprobs_pallas(model, tpack).detach().numpy(), want, atol=LOGP_ATOL
        )


def test_tree_train_logprobs_gradient_sparse_equals_dense():
    """The sparse path's gradient in every parameter equals the dense
    path's (JAX's test_tree_training_grad_parity)."""
    _, model = _models(seed=2)
    model.requires_grad_(True)
    pack = ttree.build_tree(_forest(seed=7, groups=((40, 3, 12), (30, 2, 10)), vocab=TINY_QWEN2.vocab_size))
    grads = {}
    for impl in ("sparse", "dense"):
        model.zero_grad()
        ttree.tree_train_logprobs(model, pack, impl=impl).sum().backward()
        grads[impl] = {n: p.grad.clone() for n, p in model.named_parameters()}
    for n, g in grads["dense"].items():
        np.testing.assert_allclose(grads["sparse"][n].numpy(), g.numpy(), atol=GRAD_RTOL * g.abs().max().item(),
                                   err_msg=n)
