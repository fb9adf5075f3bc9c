"""The port's ``ops/functional.py`` against ``areal_tpu/ops/functional.py``:
values, and gradients (torch autograd against ``jax.grad``), on the same f32
inputs drawn from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.ops import functional as JF
from areal_tpu_torch.ops import functional as TF

# f32 elementwise math with other reduction orders
TOL = dict(atol=1e-5, rtol=1e-5)


def _batch(seed=0, B=4, L=24):
    rng = np.random.default_rng(seed)
    logp = rng.normal(-2.0, 0.5, (B, L)).astype(np.float32)
    prox = (logp + rng.normal(0, 0.3, (B, L))).astype(np.float32)
    old = (logp + rng.normal(0, 0.3, (B, L))).astype(np.float32)
    adv = rng.normal(0, 1, (B, L)).astype(np.float32)
    mask = rng.uniform(size=(B, L)) < 0.7
    mask[0] = False  # a row with no valid token
    return logp, prox, old, adv, mask


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _assert_stats(tstat: dict, jstat: dict):
    assert set(tstat) == set(jstat)
    for name in jstat:
        np.testing.assert_allclose(
            tstat[name].numpy().astype(np.float32), np.asarray(jstat[name]).astype(np.float32),
            err_msg=name, **TOL,
        )


@pytest.mark.parametrize("unbiased", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dim", [None, 1])
def test_masked_normalization(unbiased, masked, dim):
    x, _, _, _, mask = _batch(1)
    m = mask if masked else None
    want = JF.masked_normalization(jnp.asarray(x), None if m is None else jnp.asarray(m), axis=dim, unbiased=unbiased)
    got = TF.masked_normalization(_t(x), None if m is None else _t(m), dim=dim, unbiased=unbiased)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("est", ["k1", "k2", "k3"])
def test_approx_kl(est):
    logp, prox, *_ = _batch(2)
    np.testing.assert_allclose(
        TF.approx_kl(_t(logp), _t(prox), est).numpy(),
        np.asarray(JF.approx_kl(jnp.asarray(logp), jnp.asarray(prox), est)),
        **TOL,
    )
    with pytest.raises(ValueError):
        TF.approx_kl(_t(logp), _t(prox), "k4")


def test_gae():
    rng = np.random.default_rng(3)
    B, L = 3, 20
    rewards = rng.normal(0, 1, (B, L)).astype(np.float32)
    values = rng.normal(0, 1, (B, L)).astype(np.float32)
    mask = (rng.uniform(size=(B, L)) < 0.8).astype(np.float32)
    no_eos = np.array([True, False, True])
    want = JF.gae(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(mask), jnp.asarray(no_eos), 0.99, 0.95)
    got = TF.gae(_t(rewards), _t(values), _t(mask), _t(no_eos), 0.99, 0.95)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["token_mask", "token_truncate", "sequence_mask", "sequence_truncate"])
@pytest.mark.parametrize("cap", [None, 1.2])
def test_compute_behave_imp_weight(mode, cap):
    _, prox, old, _, mask = _batch(4)
    jw = JF.compute_behave_imp_weight(jnp.asarray(prox), jnp.asarray(old), jnp.asarray(mask), mode, cap)
    tw = TF.compute_behave_imp_weight(_t(prox), _t(old), _t(mask), mode, cap)
    for got, want in zip(tw, jw):
        np.testing.assert_allclose(got.numpy().astype(np.float32), np.asarray(want).astype(np.float32), **TOL)


PPO_VARIANTS = {
    "grpo": dict(),
    "decoupled-capped": dict(behave_imp_weight_cap=1.5, behave_imp_weight_mode="token_truncate"),
    "dapo-clip-higher": dict(eps_clip_higher=0.28),
    "dual-clip": dict(c_clip=3.0),
    "gspo": dict(importance_sampling_level="sequence", behave_imp_weight_mode="sequence_mask"),
    "no-behave": dict(behave_imp_weight_mode="disabled"),
}


@pytest.mark.parametrize("variant", list(PPO_VARIANTS))
def test_ppo_actor_loss_value_stats_and_grad(variant):
    logp, prox, old, adv, mask = _batch(5)
    kw = PPO_VARIANTS[variant]

    def jloss(lp):
        return JF.ppo_actor_loss_fn(lp, jnp.asarray(prox), jnp.asarray(old), jnp.asarray(adv), jnp.asarray(mask), **kw)

    (jl, jstat), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logp))
    tlp = _t(logp).requires_grad_(True)
    tl, tstat = TF.ppo_actor_loss_fn(tlp, _t(prox), _t(old), _t(adv), _t(mask), **kw)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    np.testing.assert_allclose(tlp.grad.numpy(), np.asarray(jg), **TOL)
    _assert_stats(tstat, jstat)


@pytest.mark.parametrize("level", ["token", "sequence"])
def test_sapo_loss_value_and_grad(level):
    logp, _, old, adv, mask = _batch(6)

    def jloss(lp):
        return JF.sapo_loss_fn(lp, jnp.asarray(old), jnp.asarray(adv), jnp.asarray(mask), 1.0, 1.05, level)

    (jl, jstat), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logp))
    tlp = _t(logp).requires_grad_(True)
    tl, tstat = TF.sapo_loss_fn(tlp, _t(old), _t(adv), _t(mask), 1.0, 1.05, level)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    np.testing.assert_allclose(tlp.grad.numpy(), np.asarray(jg), **TOL)
    _assert_stats(tstat, jstat)


@pytest.mark.parametrize("kind", ["mse", "huber"])
def test_ppo_critic_loss_value_and_grad(kind):
    rng = np.random.default_rng(7)
    value, old, target = (rng.normal(0, 8, (3, 16)).astype(np.float32) for _ in range(3))
    mask = rng.uniform(size=(3, 16)) < 0.8

    def jloss(v):
        return JF.ppo_critic_loss_fn(v, jnp.asarray(old), jnp.asarray(target), jnp.asarray(mask), 0.5, kind)

    (jl, jstat), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(value))
    tv = _t(value).requires_grad_(True)
    tl, tstat = TF.ppo_critic_loss_fn(tv, _t(old), _t(target), _t(mask), 0.5, kind)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jg), **TOL)
    _assert_stats(tstat, jstat)


@pytest.mark.parametrize("tau", [0.01, 0.04, 10.0])
def test_m2po_loss_mask(tau):
    _, prox, old, _, mask = _batch(8, B=5, L=40)
    want = np.asarray(JF.m2po_loss_mask(jnp.asarray(old), jnp.asarray(prox), jnp.asarray(mask), tau))
    got = TF.m2po_loss_mask(_t(old), _t(prox), _t(mask), tau).numpy()
    np.testing.assert_array_equal(got, want)


def test_reward_overlong_penalty():
    rewards = np.array([1.0, 0.5, -1.0, 0.0], np.float32)
    lens = np.array([10, 90, 100, 128], np.int32)
    want = JF.reward_overlong_penalty(jnp.asarray(rewards), jnp.asarray(lens), 32, 1.0, 128)
    got = TF.reward_overlong_penalty(_t(rewards), _t(lens), 32, 1.0, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
