"""The port's ``trainer/ppo.py`` against ``areal_tpu/trainer/ppo.py``:
``compute_advantages`` (identical host arrays), ``grpo_loss_fn`` (value,
stats and gradient on one packed grid) and ``ppo_update`` end to end on
two minibatches, the port's engine holding the JAX engine's weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.config import NormConfig as JNormConfig
from areal_tpu.api.config import PPOActorConfig as JPPOActorConfig
from areal_tpu.trainer import ppo as jppo
from areal_tpu.utils import data as jdata
from areal_tpu.utils import grid as jgrid
from areal_tpu_torch.api.config import NormConfig, PPOActorConfig
from areal_tpu_torch.trainer import ppo as tppo

from test_torch_train_engine import _engines, _trajs

# host numpy in f32 on both sides, the same operations in the same order
EXACT = dict(atol=1e-6, rtol=1e-6)


class _Engine:
    def __init__(self, version):
        self.version = version

    def get_version(self):
        return self.version


VARIANTS = {
    "grpo-recompute": dict(),
    "loglinear": dict(prox_logp_mode="loglinear"),
    "kl-ref-k3": dict(kl_ctl=0.1, kl_estimator="k3"),
    "overlong": dict(overlong_reward_penalty=True, overlong_tokens=8, overlong_penalty_factor=0.5, max_response_length=24),
    "no-eos-zero-and-mask": dict(mask_no_eos_with_zero=True, mask_too_long_tokens=True),
    "group-reward-norm": dict(group_reward_norm=True, reward_scaling=2.0, reward_bias=-0.5),
    "coupled-recompute": dict(use_decoupled_loss=False, recompute_logprob=True),
    "gae": dict(gamma=0.9, lam=0.8, adv_norm=None),
}


def _configs(**kw):
    base = dict(group_size=4)
    adv = kw.pop("adv_norm", "grpo")
    jkw, tkw = dict(base, **kw), dict(base, **kw)
    if adv == "grpo":
        jkw["adv_norm"] = JNormConfig(mean_level="group", std_level="batch", group_size=4)
        tkw["adv_norm"] = NormConfig(mean_level="group", std_level="batch", group_size=4)
    else:
        jkw["adv_norm"] = tkw["adv_norm"] = None
    return JPPOActorConfig(**jkw), PPOActorConfig(**tkw)


def _batch(seed, version=2):
    trajs = _trajs(8, seed=seed)
    rng = np.random.default_rng(seed + 100)
    for i, t in enumerate(trajs):
        t["seq_no_eos_mask"] = np.bool_(i % 4 == 3)  # one truncated sample per group
        gen = t["versions"] >= 0
        t["versions"][gen] = rng.integers(0, version + 1, int(gen.sum()))  # stale tokens
        t["prox_logp"] = (t["logprobs"] + rng.normal(0, 0.1, t["logprobs"].shape) * gen).astype(np.float32)
        t["ref_logp"] = (t["logprobs"] + rng.normal(0, 0.1, t["logprobs"].shape) * gen).astype(np.float32)
    return jdata.pad_sequences_to_tensors(trajs)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_compute_advantages_identical(variant):
    jcfg, tcfg = _configs(**VARIANTS[variant])
    batch = _batch(20)
    if VARIANTS[variant].get("prox_logp_mode") == "loglinear":
        batch.pop("prox_logp")
    want = jppo.PPOActor(jcfg, _Engine(2)).compute_advantages(batch)
    got = tppo.PPOActor(tcfg, _Engine(2)).compute_advantages(batch)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(
            np.asarray(got[k], np.float64), np.asarray(want[k], np.float64), err_msg=k, **EXACT
        )
    assert np.abs(got["advantages"]).max() > 0


def _device_grid(adv):
    """One packed grid of the label-aligned batch, with random label-aligned
    model logprobs / entropy standing in for the forward's outputs."""
    grid = jgrid.pack_grid(adv, bucket_step=64)
    from areal_tpu.models import qwen as jq

    seg = grid.data["segment_ids"]
    labels, valid = jq.make_causal_inputs(grid.data["input_ids"], seg)
    b = {k: np.asarray(v) for k, v in grid.data.items() if np.asarray(v).shape[:2] == seg.shape}
    b.update(labels=labels, label_valid=valid)
    rng = np.random.default_rng(3)
    logp = (grid.data["old_logprobs"] + rng.normal(0, 0.2, seg.shape)).astype(np.float32)
    ent = rng.uniform(1, 5, seg.shape).astype(np.float32)
    return b, logp, ent


@pytest.mark.parametrize(
    "variant",
    ["grpo-recompute", "loglinear", "sapo", "m2po", "entropy-bonus", "dual-clip-seq"],
)
def test_grpo_loss_fn_value_stats_grad(variant):
    kw = {
        "sapo": dict(use_sapo_loss=True, use_decoupled_loss=False),
        "m2po": dict(use_m2po_loss=True, m2po_tau=0.001),
        "entropy-bonus": dict(entropy_coeff=0.01),
        "dual-clip-seq": dict(c_clip=3.0, imp_ratio_level="sequence", behave_imp_weight_mode="sequence_truncate", behav_imp_weight_cap=2.0),
        "loglinear": dict(prox_logp_mode="loglinear"),
    }.get(variant, {})
    jcfg, tcfg = _configs(**kw)
    batch = _batch(21)
    if variant == "loglinear":
        batch.pop("prox_logp")
    adv = jppo.PPOActor(jcfg, _Engine(2)).compute_advantages(batch)
    b, logp, ent = _device_grid(adv)

    def jl(lp, e):
        return jppo.grpo_loss_fn({"logprobs": lp, "entropy": e}, {k: jnp.asarray(v) for k, v in b.items()}, jcfg)

    (jloss, jstats), (jg, jge) = jax.value_and_grad(jl, argnums=(0, 1), has_aux=True)(jnp.asarray(logp), jnp.asarray(ent))
    tlp = torch.from_numpy(logp).requires_grad_(True)
    te = torch.from_numpy(ent).requires_grad_(True)
    tloss, tstats = tppo.grpo_loss_fn({"logprobs": tlp, "entropy": te}, {k: torch.from_numpy(v) for k, v in b.items()}, tcfg)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(tlp.grad.numpy(), np.asarray(jg), atol=1e-7, rtol=1e-5)
    np.testing.assert_allclose(
        te.grad.numpy() if te.grad is not None else np.zeros_like(ent), np.asarray(jge), atol=1e-7, rtol=1e-5
    )
    # the port leaves out the learning-health stats (lag buckets)
    assert set(tstats) == {k for k in jstats if not k.startswith("lag_")}
    for k, v in tstats.items():
        np.testing.assert_allclose(v.item(), float(jstats[k]), atol=1e-6, rtol=1e-5, err_msg=k)


def test_ppo_update_two_minibatches_matches_jax():
    jcfg, jeng, tcfg, teng = _engines()
    batch = jdata.pad_sequences_to_tensors(_trajs(8, seed=22))
    jactor, tactor = jppo.PPOActor(jcfg, jeng), tppo.PPOActor(tcfg, teng)
    batch["prox_logp"] = jactor.compute_logp(batch)
    np.testing.assert_allclose(tactor.compute_logp(batch), batch["prox_logp"], atol=5e-5, rtol=5e-5)
    want = jactor.ppo_update(jactor.compute_advantages(batch))
    got = tactor.ppo_update(tactor.compute_advantages(batch))
    assert len(got) == len(want) == 2
    assert [s["lr"] for s in got] == pytest.approx([s["lr"] for s in want])
    assert got[0]["lr"] == 0.0  # optax's first step
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm", "actor_loss", "n_valid_tokens", "clip_ratio"):
            np.testing.assert_allclose(g[k], w[k], rtol=2e-4, atol=1e-6, err_msg=k)
