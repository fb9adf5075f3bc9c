"""The port's flash attention (the plain versions of kernels K2-K4 that a CPU
tensor takes) against the JAX package: the forward against
``flash_fwd_pallas`` in interpret mode and ``sdpa_xla``, the backward against
``jax.grad`` of ``sdpa_xla``. Inputs are f32 from numpy seeds; padding rows
(segment 0) are compared only where every convention agrees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.ops import attention as jatt
from areal_tpu_torch.ops import attention as tatt

# f32 on the CPU: the same math with other summation orders (kernelcheck's
# interpret-vs-XLA tolerance for the TPU kernel)
FWD_TOL = 2e-4
# gradients: f32 with other summation orders, over O(1)-scaled inputs
BWD_TOL = dict(atol=2e-5, rtol=2e-4)


def _segments(G, L, layout):
    seg = np.zeros((G, L), np.int32)
    for g in range(G):
        c = 0
        for j, n in enumerate(layout[g]):
            seg[g, c : c + n] = j + 1
            c += n
    return seg


# per grid row: segment lengths; a shortfall against L is a padded tail
LAYOUTS = {
    "one-segment": lambda L: [[L], [L]],
    "three-packed": lambda L: [[L // 4, L // 2, L // 4], [40, L - 40]],
    "padded-tail": lambda L: [[L // 2, L // 4 - 3], [7]],
}


def _inputs(G, L, H, d, layout, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 1, (G, L, H, d)).astype(np.float32) for _ in range(3))
    return q, k, v, _segments(G, L, LAYOUTS[layout](L))


def _mask(seg):
    L = seg.shape[1]
    qi, ki = np.arange(L)[:, None], np.arange(L)[None, :]
    return ((qi >= ki) & (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0))[:, None]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_flash_forward_matches_pallas_interpret_and_xla(layout):
    G, L, H, d = 2, 256, 2, 128
    q, k, v, seg = _inputs(G, L, H, d, layout)
    pallas = np.asarray(
        jatt.flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg), interpret=True)
    )
    xla = np.asarray(jatt.sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(_mask(seg)), d))
    before = tatt.flash_attention_fwd.launches
    out, lse = tatt.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(seg), with_lse=True
    )
    assert tatt.flash_attention_fwd.launches == before  # a CPU tensor runs no kernel
    valid = seg != 0
    np.testing.assert_allclose(out.numpy()[valid], pallas[valid], atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(out.numpy()[valid], xla[valid], atol=FWD_TOL, rtol=FWD_TOL)
    # the port's padding convention: zero output and zero logsumexp
    assert not out.numpy()[~valid].any() and not lse.numpy()[~valid].any()
    # logsumexp of the scaled masked logits, per valid row
    logits = np.einsum("gqhd,gkhd->ghqk", q, k) * d**-0.5
    logits = np.where(_mask(seg), logits, -np.inf)
    want = np.asarray(jax.scipy.special.logsumexp(jnp.asarray(logits), axis=-1)).transpose(0, 2, 1)
    np.testing.assert_allclose(lse.numpy()[valid], want[valid], atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(tatt.flash_fwd(*map(torch.from_numpy, (q, k, v, seg))).numpy(), out.numpy())


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kv_heads", [2, 1], ids=["mha", "gqa"])
def test_flash_train_backward_matches_jax_grad(layout, kv_heads):
    """flash_train's backward (K3 + K4's plain versions) against jax.grad of
    sdpa_xla, through the KV-head repeat the model applies."""
    G, L, H, d = 2, 128, 2, 64
    q, k, v, seg = _inputs(G, L, H, d, layout, seed=1)
    k, v = k[:, :, :kv_heads], v[:, :, :kv_heads]
    rep = H // kv_heads
    rng = np.random.default_rng(2)
    # the loss gives padding rows no gradient
    dout = rng.normal(0, 1, (G, L, H, d)).astype(np.float32) * (seg != 0)[:, :, None, None]
    mask = jnp.asarray(_mask(seg))

    def jloss(q_, k_, v_):
        o = jatt.sdpa_xla(q_, jnp.repeat(k_, rep, axis=2), jnp.repeat(v_, rep, axis=2), mask, d)
        return (o * dout).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tatt.flash_train(
        tq, tk.repeat_interleave(rep, dim=2), tv.repeat_interleave(rep, dim=2), torch.from_numpy(seg)
    )
    (out * torch.from_numpy(dout)).sum().backward()
    for name, t, j in zip("qkv", (tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), err_msg=f"d{name}", **BWD_TOL)


def test_backward_plain_pieces_agree_with_autograd():
    """The wrappers K3 / K4 return on a CPU tensor the gradients autograd
    takes of the plain forward (di = rowsum(dO * O) from the caller)."""
    G, L, H, d = 1, 128, 2, 64
    q, k, v, seg = _inputs(G, L, H, d, "three-packed", seed=3)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    segt = torch.from_numpy(seg)
    out = tatt.sdpa_plain(tq, tk, tv, tatt.attention_mask(segt), d)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(0)) * (segt != 0)[:, :, None, None]
    (out * dout).sum().backward()
    o, lse = tatt.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), segt, with_lse=True)
    di = (dout * o).sum(-1)
    dk, dv = tatt.flash_attention_bwd_dkv(*map(torch.from_numpy, (q, k, v)), segt, dout, lse, di)
    dq = tatt.flash_attention_bwd_dq(*map(torch.from_numpy, (q, k, v)), segt, dout, lse, di)
    for got, want in ((dq, tq.grad), (dk, tk.grad), (dv, tv.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **BWD_TOL)


def test_resolve_impl():
    assert tatt.resolve_impl("pallas") == "pallas"
    assert tatt.resolve_impl("xla") == "xla"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tatt.resolve_impl("ring")
    with pytest.raises(ValueError):
        tatt.resolve_impl("flash")


def _bf16_grids(G=2, L=128, H=2, d=128):
    return [torch.zeros((G, L, H, d), dtype=torch.bfloat16) for _ in range(3)]


@pytest.mark.parametrize(
    "bad",
    ["f32", "head_dim", "seg_dtype", "seg_shape", "strided", "lse_dtype"],
)
def test_cuda_argument_checks_refuse(bad):
    """What the kernel wrappers refuse before reading raw pointers (checked
    here on CPU tensors, which the wrappers themselves never send there)."""
    q, k, v = _bf16_grids()
    seg = torch.ones((2, 128), dtype=torch.int32)
    rows = ()
    if bad == "f32":
        q = q.float()
    elif bad == "head_dim":
        q, k, v = _bf16_grids(d=96)
    elif bad == "seg_dtype":
        seg = seg.long()
    elif bad == "seg_shape":
        seg = seg[:, :64]
    elif bad == "strided":
        k = torch.zeros((2, 128, 4, 128), dtype=torch.bfloat16)[:, :, ::2]
    elif bad == "lse_dtype":
        rows = (torch.zeros((2, 128, 2), dtype=torch.float64),)
    with pytest.raises((TypeError, ValueError)):
        tatt._check_cuda_args("flash", seg, (q, k, v), rows)


def test_cuda_argument_checks_accept_the_model_layout():
    q, k, v = _bf16_grids()
    seg = torch.ones((2, 128), dtype=torch.int32)
    tatt._check_cuda_args("flash", seg, (q, k, v), (torch.zeros((2, 128, 2)),))
