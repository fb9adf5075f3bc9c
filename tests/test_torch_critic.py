"""The critic against the JAX package on the CPU: the value-head engine
(``TorchTrainEngine(value_head=True)``) against a one-device
``JaxTrainEngine(value_head=True)`` on the same weights and batches, the
value head through ``models/convert.py``, ``critic_loss_fn`` and
``PPOCritic.ppo_update``, ``PPOTrainer`` with a critic over a stub rollout,
and the critic's durable state."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from areal_tpu.api import config as jc
from areal_tpu.api.io_struct import FinetuneSpec as JFinetuneSpec
from areal_tpu.engine.train_engine import JaxTrainEngine
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu.trainer import ppo as jppo
from areal_tpu.trainer.rl_trainer import PPOTrainer as JPPOTrainer
from areal_tpu.utils import data as jdata
from areal_tpu_torch.api import config as tc
from areal_tpu_torch.api.io_struct import FinetuneSpec, SaveLoadMeta
from areal_tpu_torch.engine.train_engine import TorchTrainEngine
from areal_tpu_torch.models import convert
from areal_tpu_torch.trainer import ppo as tppo
from areal_tpu_torch.trainer.rl_trainer import PPOTrainer

from test_torch_ppo_trainer_loop import ACTOR, _flat, _StubRollout
from test_torch_qwen import jax_params, port_cfg
from test_torch_train_engine import _trajs
from tpu_testing import TINY_QWEN2

LR = 1e-3
# Adam's eps at 1e-5 (as the loop twin): an element whose gradient is near
# zero takes a step smooth in the gradient, so f32 summation order moves
# the weights by f32 noise, not by ~LR
ADAM_EPS = 1e-5
VALUE_TOL = 1e-5  # f32 values, position by position
LOSS_RTOL = 1e-5  # f32 losses of the same weights and batch
STAT_TOL = 1e-6  # critic_loss / value_clip_ratio on the same grid
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)  # every leaf after an update (the loop twin's)
CRITIC = dict(dtype="float32", param_dtype="float32", bucket_step=64)
MCFG = port_cfg(TINY_QWEN2)


def _head(seed: int, scale: float = 0.05) -> np.ndarray:
    return (scale * np.random.default_rng(seed).standard_normal(TINY_QWEN2.hidden_size)).astype(np.float32)


def _params(seed: int = 3, head: np.ndarray | None = None) -> dict:
    p = jax_params(TINY_QWEN2, seed=seed)
    p["value_head"] = np.zeros(TINY_QWEN2.hidden_size, np.float32) if head is None else head
    return p


def _jax_critic(params: dict, n_minibatches: int = 2) -> tuple[jc.PPOCriticConfig, JaxTrainEngine]:
    cfg = jc.PPOCriticConfig(
        init_from_scratch=True,
        mesh=jc.MeshConfig(data=1),
        optimizer=jc.OptimizerConfig(lr=LR, eps=ADAM_EPS),
        ppo_n_minibatches=n_minibatches,
        **CRITIC,
    )
    eng = JaxTrainEngine(cfg, value_head=True, model_config=TINY_QWEN2)
    eng.initialize(JFinetuneSpec(1, 16, 4), mesh=mesh_lib.make_mesh(cfg.mesh, devices=jax.devices()[:1]))
    eng.params = jax.tree.map(lambda old, new: jax.device_put(jnp.asarray(new), old.sharding), eng.params, params)
    return cfg, eng


def _port_critic(params: dict, n_minibatches: int = 2) -> tuple[tc.PPOCriticConfig, TorchTrainEngine]:
    cfg = tc.PPOCriticConfig(optimizer=tc.OptimizerConfig(lr=LR, eps=ADAM_EPS), ppo_n_minibatches=n_minibatches,
                             **CRITIC)
    eng = TorchTrainEngine(cfg, value_head=True, model_config=MCFG, device="cpu")
    eng.initialize(FinetuneSpec(1, 16, 4))
    eng.model.load_state_dict(convert.from_jax_params(params, MCFG))
    return cfg, eng


def _leaves_close(teng: TorchTrainEngine, jeng: JaxTrainEngine, what: str) -> None:
    got = _flat(convert.to_jax_params(dict(teng.model.named_parameters()), MCFG))
    want = _flat(jax.tree.map(np.asarray, jeng.params))
    assert got.keys() == want.keys() and "['value_head']" in want
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **PARAM_TOL, err_msg=f"{what}: {key}")


def _batch(seed: int) -> dict:
    return jdata.pad_sequences_to_tensors(_trajs(8, seed=seed))


# ---------------------------------------------------------------------------
# the value-head engine
# ---------------------------------------------------------------------------


def test_value_head_engine_matches_jax():
    """The twin of ``tests/test_train_engine.py::test_value_head_engine`` on
    one device: from a zero head (the first values are exactly 0), the same
    losses step by step, then the values of ``forward_batch(output_key=
    "values")`` position by position; the LM head takes no gradient and
    decays as optax decays it."""
    params = _params()
    _, jeng = _jax_critic(params)
    _, teng = _port_critic(params)
    batch = _batch(30)
    assert np.all(teng.forward_batch(batch, output_key="values") == 0.0)

    def jloss(o, b):
        lm = (b["loss_mask"] > 0).astype(jnp.float32)
        return (jnp.square(o["values"] - 1.0) * lm).sum() / jnp.maximum(lm.sum(), 1), {}

    def tloss(o, b):
        lm = (b["loss_mask"] > 0).float()
        return (torch.square(o["values"] - 1.0) * lm).sum() / torch.clamp(lm.sum(), min=1), {}

    def wfn(d):
        return float((np.asarray(d["loss_mask"]) > 0).sum())

    want = [jeng.train_batch(batch, jloss, wfn)["loss"] for _ in range(6)]
    got = [teng.train_batch(batch, tloss, wfn)["loss"] for _ in range(6)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    want_v = jeng.forward_batch(batch, output_key="values")
    got_v = teng.forward_batch(batch, output_key="values")
    attn = np.asarray(batch["attention_mask"], bool)
    assert got_v.shape == attn.shape and np.all(got_v[~attn] == 0) and np.abs(got_v[attn]).min() > 0
    np.testing.assert_allclose(got_v, want_v, atol=VALUE_TOL, rtol=0)
    _leaves_close(teng, jeng, "after 6 steps")


def test_values_are_token_aligned():
    """``values`` copy into the batch as they are (value of the prefix up to
    and including token t at t), where logprobs shift right one: a
    sequence's values do not depend on the tokens after it, so the value
    at position t of a row equals the last value of its t+1 prefix."""
    _, teng = _port_critic(_params(head=_head(1)))
    ids = np.random.default_rng(2).integers(0, 256, 12).astype(np.int32)
    batch = jdata.pad_sequences_to_tensors(
        [{"input_ids": ids[:n], "loss_mask": np.ones(n, np.float32)} for n in (12, 7, 1)]
    )
    vals = teng.forward_batch(batch, output_key="values")
    np.testing.assert_allclose(vals[1, :7], vals[0, :7], atol=VALUE_TOL, rtol=0)
    np.testing.assert_allclose(vals[2, 0], vals[0, 0], atol=VALUE_TOL, rtol=0)
    assert vals[2, 0] != 0 and np.all(vals[1, 7:] == 0)


def test_value_head_round_trips_through_convert():
    params = _params(head=_head(4))
    state = convert.from_jax_params(params, MCFG)
    assert state["value_head"].dtype == torch.float32 and state["value_head"].shape == (TINY_QWEN2.hidden_size,)
    back = convert.to_jax_params(state, MCFG)
    np.testing.assert_array_equal(back["value_head"], params["value_head"])
    _, teng = _port_critic(params)
    out = convert.to_jax_params(dict(teng.model.named_parameters()), MCFG)
    assert out["value_head"].tobytes() == params["value_head"].tobytes()
    # the JAX engine's tree and the bridge's carry the same leaves
    _, jeng = _jax_critic(params)
    assert set(_flat(jax.tree.map(np.asarray, jeng.params))) == set(_flat(out))


# ---------------------------------------------------------------------------
# the loss and the update
# ---------------------------------------------------------------------------


def test_critic_loss_fn_matches_jax():
    rng = np.random.default_rng(5)
    G, L = 3, 40
    b = {
        "old_values": rng.normal(0, 1, (G, L)).astype(np.float32),
        "target_values": rng.normal(0, 1, (G, L)).astype(np.float32),
        "loss_mask": (rng.uniform(size=(G, L)) < 0.7).astype(np.float32),
        "label_valid": rng.uniform(size=(G, L)) < 0.9,
    }
    values = b["old_values"] + rng.normal(0, 0.6, (G, L)).astype(np.float32)
    for eps_clip in (0.2, 0.5):
        jloss, jst = jppo.critic_loss_fn({"values": jnp.asarray(values)}, {k: jnp.asarray(v) for k, v in b.items()},
                                         jc.PPOCriticConfig(eps_clip=eps_clip))
        tloss, tst = tppo.critic_loss_fn({"values": torch.from_numpy(values)},
                                         {k: torch.from_numpy(v) for k, v in b.items()},
                                         tc.PPOCriticConfig(eps_clip=eps_clip))
        assert 0 < float(tst["value_clip_ratio"]) < 1
        np.testing.assert_allclose(float(tloss), float(jloss), atol=STAT_TOL, rtol=0)
        for k in ("critic_loss", "value_clip_ratio"):
            np.testing.assert_allclose(float(tst[k]), float(jst[k]), atol=STAT_TOL, rtol=0, err_msg=k)


class _Version:
    def get_version(self):
        return 0


def test_ppo_critic_update_matches_jax():
    """``PPOCritic.ppo_update`` from a nonzero head (so the body takes a
    gradient too) over two minibatches of the batch ``compute_advantages``
    made from the critic's own values: every leaf after the two steps, and
    each minibatch's stats."""
    params = _params(head=_head(6))
    jcfg, jeng = _jax_critic(params)
    tcfg, teng = _port_critic(params)
    batch = _batch(31)
    batch["values"] = jeng.forward_batch(batch, output_key="values")
    np.testing.assert_allclose(teng.forward_batch(batch, output_key="values"), batch["values"], atol=VALUE_TOL,
                               rtol=0)
    acfg = jc.PPOActorConfig(**{k: v for k, v in ACTOR.items()})
    adv = jppo.PPOActor(acfg, _Version()).compute_advantages(batch)
    assert "values" in adv and "returns" in adv
    want = jppo.PPOCritic(jcfg, jeng).ppo_update(adv)
    got = tppo.PPOCritic(tcfg, teng).ppo_update(adv)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("loss", "critic_loss", "value_clip_ratio", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=2e-4, atol=STAT_TOL, err_msg=k)
    assert want[1]["grad_norm"] > 0 and want[1]["lr"] > 0
    _leaves_close(teng, jeng, "after ppo_update")
    moved = convert.to_jax_params(dict(teng.model.named_parameters()), MCFG)
    assert np.abs(moved["value_head"] - params["value_head"]).max() > LR / 2
    assert np.abs(moved["layers"]["wq"] - params["layers"]["wq"]).max() > LR / 2


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

N_STEPS = 2


def _loop_cfg(pkg, root: str, critic_cfg):
    actor = pkg.PPOActorConfig(
        optimizer=pkg.OptimizerConfig(lr=LR, eps=ADAM_EPS),
        adv_norm=pkg.NormConfig(mean_level="group", std_level="batch", group_size=4),
        **({"init_from_scratch": True, "mesh": pkg.MeshConfig(data=1)} if pkg is jc else {}),
        **ACTOR,
    )
    cfg = pkg.PPOConfig(
        total_train_steps=N_STEPS,
        weight_update_mode="mem",
        train_dataset=pkg.DatasetConfig(batch_size=4),
        actor=actor,
        critic=critic_cfg,
        preemption=pkg.PreemptionConfig(enabled=False),
        saver=pkg.SaverConfig(fileroot=root),
        checkpointer=pkg.SaverConfig(fileroot=root),
        evaluator=pkg.EvaluatorConfig(fileroot=root),
        recover=pkg.RecoverConfig(fileroot=root),
        stats_logger=pkg.StatsLoggerConfig(fileroot=root),
    )
    cfg.cluster.fileroot = root
    return cfg


def _run_loop(trainer_cls, cfg, actor_eng, critic_eng, stub):
    trainer = trainer_cls(cfg, [{"prompt_ids": [1, 2, 3]}] * 16, rollout=stub, actor_engine=actor_eng,
                          critic_engine=critic_eng)
    seen, committed = [], []
    update = trainer.critic.ppo_update

    def recorded(data):
        seen.append({k: np.array(data[k], copy=True) for k in ("values", "returns", "advantages")})
        return update(data)

    trainer.critic.ppo_update = recorded
    trainer.stats_logger.commit = lambda epoch, step, gstep, stats: committed.append(stats)
    trainer.train()
    trainer.close()
    return seen, committed


def test_ppo_trainer_with_critic_matches_jax(tmp_path):
    """``PPOTrainer`` with ``critic=PPOCriticConfig(...)`` for two global
    steps over the stub rollout, against JAX's: the batch's ``values``,
    ``returns`` and ``advantages`` the critic trains on, the ``ppo_critic/*``
    stats, the critic's version and weights, and the actor's pushes."""
    from areal_tpu.utils import stats_tracker as j_stats
    from areal_tpu_torch.utils import stats_tracker as t_stats

    j_stats.export_all()
    t_stats.export_all()
    actor_params = jax_params(TINY_QWEN2, seed=5)
    critic_params = _params(seed=7, head=_head(8))
    batches = [jdata.pad_sequences_to_tensors(_trajs(8, seed=40 + s)) for s in range(N_STEPS)]

    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jcfg = _loop_cfg(jc, jroot, jc.PPOCriticConfig(
        init_from_scratch=True, mesh=jc.MeshConfig(data=1), optimizer=jc.OptimizerConfig(lr=LR, eps=ADAM_EPS),
        ppo_n_minibatches=2, **CRITIC))
    jactor = JaxTrainEngine(jcfg.actor, model_config=TINY_QWEN2)
    jactor.initialize(JFinetuneSpec(1, 16, 4), mesh=mesh_lib.make_mesh(jcfg.actor.mesh, devices=jax.devices()[:1]))
    jactor.params = jax.tree.map(lambda old, new: jax.device_put(jnp.asarray(new), old.sharding), jactor.params,
                                 actor_params)
    _, jcritic = _jax_critic(critic_params)
    jstub = _StubRollout(batches, lambda p: _flat(jax.tree.map(np.asarray, p)))
    jseen, jstats = _run_loop(JPPOTrainer, jcfg, jactor, jcritic, jstub)

    tcfg = _loop_cfg(tc, troot, tc.PPOCriticConfig(optimizer=tc.OptimizerConfig(lr=LR, eps=ADAM_EPS),
                                                   ppo_n_minibatches=2, **CRITIC))
    tactor = TorchTrainEngine(tcfg.actor, model_config=MCFG, device="cpu")
    tactor.initialize(FinetuneSpec(1, 16, 4))
    tactor.model.load_state_dict(convert.from_jax_params(actor_params, MCFG))
    _, tcritic = _port_critic(critic_params)
    tstub = _StubRollout(batches, lambda p: _flat(convert.to_jax_params(p, MCFG)))
    tseen, tstats = _run_loop(PPOTrainer, tcfg, tactor, tcritic, tstub)

    assert tstub.calls == jstub.calls
    assert len(tseen) == len(jseen) == N_STEPS
    for step, (g, w) in enumerate(zip(tseen, jseen)):
        np.testing.assert_allclose(g["values"], w["values"], atol=VALUE_TOL, rtol=0, err_msg=f"step {step}: values")
        for k in ("returns", "advantages"):
            np.testing.assert_allclose(g[k], w[k], atol=1e-4, rtol=1e-4, err_msg=f"step {step}: {k}")
    # the second step's values come from the updated critic
    before = _port_critic(critic_params)[1].forward_batch(batches[1], output_key="values")
    assert np.abs(tseen[1]["values"] - before).max() > 1e-4
    assert len(tstats) == len(jstats) == N_STEPS
    for t, j in zip(tstats, jstats):
        keys = sorted(k for k in j if k.startswith("ppo_critic/"))
        assert keys and keys == sorted(k for k in t if k.startswith("ppo_critic/"))
        assert set(t) == set(j)
        for k in ("ppo_critic/critic_loss", "ppo_critic/value_clip_ratio", "ppo_critic/loss"):
            np.testing.assert_allclose(t[k], j[k], rtol=2e-4, atol=STAT_TOL, err_msg=k)
    assert tcritic.get_version() == jcritic.get_version() == N_STEPS
    _leaves_close(tcritic, jcritic, "the critic after the loop")
    # the critic ships nothing: every push is the actor's tree, no value head
    for got, want in zip(tstub.pushed, jstub.pushed):
        assert got.keys() == want.keys() and not any("value_head" in k for k in got)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], **PARAM_TOL, err_msg=key)


# ---------------------------------------------------------------------------
# durable state
# ---------------------------------------------------------------------------


def _trained_critic() -> TorchTrainEngine:
    _, eng = _port_critic(_params(head=_head(9)))
    batch = _batch(32)
    batch["values"] = eng.forward_batch(batch, output_key="values")
    adv = tppo.PPOActor(tc.PPOActorConfig(**ACTOR), _Version()).compute_advantages(batch)
    tppo.PPOCritic(eng.config, eng).ppo_update(adv)
    return eng


def test_critic_recover_state_keeps_head_and_moments(tmp_path):
    eng = _trained_critic()
    names = [n for n, _ in eng.model.named_parameters()]
    i = names.index("value_head")
    assert float(eng._opt.mu[i].abs().max()) > 0 and float(eng._opt.nu[i].abs().max()) > 0
    want = {"head": eng.model.value_head.detach().clone(), "mu": eng._opt.mu[i].clone(),
            "nu": eng._opt.nu[i].clone(), "count": eng._opt.count}
    path = str(tmp_path / "rec")
    eng.save(SaveLoadMeta(path=path, weight_format="state", with_optim=True))
    _, other = _port_critic(_params(seed=11))
    other.load(SaveLoadMeta(path=path, weight_format="state", with_optim=True))
    assert torch.equal(other.model.value_head, want["head"])
    assert torch.equal(other._opt.mu[i], want["mu"]) and torch.equal(other._opt.nu[i], want["nu"])
    assert other._opt.count == want["count"]
    for (n, a), (_, b) in zip(eng.model.named_parameters(), other.model.named_parameters()):
        assert torch.equal(a, b), n
    # offload / onload and the memory ledger carry the head too
    ledger = other.hbm_ledger()
    assert ledger["components"]["params"] == sum(p.numel() * 4 for p in other.model.parameters())
    assert any(t is other.model.value_head for t in other._offload_targets())


def test_hf_export_has_no_value_head_and_hf_load_keeps_it(tmp_path):
    from areal_tpu_torch.utils.safetensors_io import SafetensorsFile

    eng = _trained_critic()
    head = eng.model.value_head.detach().clone()
    path = str(tmp_path / "hf")
    eng.save(SaveLoadMeta(path=path, weight_format="hf"))
    names = set(SafetensorsFile(os.path.join(path, "model.safetensors")).keys())
    assert names and not any("value" in n for n in names)
    assert "value_head" not in eng._export_params()
    body = {n: p.detach().clone() for n, p in eng.model.named_parameters()}
    with torch.no_grad():
        for p in eng.model.parameters():
            p.add_(0.5)
    eng.load(SaveLoadMeta(path=path, weight_format="hf"))
    for n, p in eng.model.named_parameters():
        if n == "value_head":
            assert torch.equal(p, head + 0.5)  # the engine's head, untouched by the load
        else:
            assert torch.equal(p, body[n]), n
    # a critic started from the export (as PPOCriticConfig.path loads one):
    # the body is the export's, the head starts at zero
    cfg = tc.PPOCriticConfig(path=path, **CRITIC)
    fresh = TorchTrainEngine(cfg, value_head=True, device="cpu")
    fresh.initialize(FinetuneSpec(1, 16, 4))
    assert torch.equal(fresh.model.value_head, torch.zeros(TINY_QWEN2.hidden_size))
    for n, p in fresh.model.named_parameters():
        if n != "value_head":
            assert torch.equal(p, body[n]), n

