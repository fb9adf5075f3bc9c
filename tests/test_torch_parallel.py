"""The trainer across GPUs, held on the CPU: spawned gloo worlds of the port
(``tests/torch_dist_child.py``) against the JAX engine on a CPU mesh of the
same shape, from the same numpy weights (``models/convert.py``).

- 4 ranks, ``fsdp=2, model=2``, a tiny f32 Qwen2 (2 layers, hidden 64, 4
  heads, 2 KV heads, vocab 128) with tied and with untied embeddings:
  ``forward_batch`` logprobs, two ``train_batch`` steps of the GRPO loss
  (loss and grad norm), the gathered parameters; the vocab-parallel
  embedding and logprobs against the unsharded port functions.
- 2 ranks, ``data=2``: the same twin; a recover save on the mesh loaded by
  an unsharded engine bit for bit, whose own save is the same bytes; an
  unsharded save loaded on the mesh; the bytes rank 0 hands the weight
  push; the rollout coordinator; one step of ``PPOTrainer.train`` with
  ``allocation_mode`` set and the port's CPU server on rank 0.

Both worlds run while the JAX engines compute their side (in threads:
XLA compiles outside the GIL), so the module costs about the slowest of
them.

Tolerances: the sharded engines sum their f32 gradients, norms and
softmax terms in another order than JAX's XLA on a mesh does: loss and
grad norm within 1e-5 relative, logprobs within 1e-5, and every element of
every parameter after two steps within rtol 1e-5 / atol 1e-6, with Adam's
eps at 1e-5 as in ``test_torch_ppo_trainer_loop.py`` (at optax's 1e-8 an
element whose gradient is near zero takes a sign-like step that f32
summation order moves by up to ~LR). The vocab-parallel embedding is exact
(one rank's row plus zeros); its logprobs, entropy and their gradient
within 1e-5 of the unsharded functions.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api import alloc_mode as jam
from areal_tpu.api import config as jc
from areal_tpu.api.io_struct import FinetuneSpec as JFinetuneSpec
from areal_tpu.engine import train_engine as jte
from areal_tpu.infra import dist_rollout as jdr
from areal_tpu.parallel import mesh as jmesh
from areal_tpu.trainer import ppo as jppo
from areal_tpu.utils import data as jdata
from areal_tpu_torch.api import alloc_mode as tam
from areal_tpu_torch.api import config as tc
from areal_tpu_torch.api.io_struct import FinetuneSpec, SaveLoadMeta
from areal_tpu_torch.engine.train_engine import TorchTrainEngine
from areal_tpu_torch.infra import dist_rollout as tdr
from areal_tpu_torch.inference.client import RemoteTorchEngine
from areal_tpu_torch.models import convert
from areal_tpu_torch.models.hf import save_params_to_hf
from areal_tpu_torch.parallel import mesh as tmesh
from areal_tpu_torch.trainer import ppo as tppo

import torch_dist_child as child
from test_torch_qwen import jax_params, port_cfg
from test_torch_train_engine import _trajs
from tpu_testing import TINY_QWEN2

LR = 1e-3
ADAM_EPS = 1e-5
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
COMMON = dict(dtype="float32", param_dtype="float32", bucket_step=64, logprob_chunk_size=48, group_size=4,
              ppo_n_minibatches=2, use_decoupled_loss=True, prox_logp_mode="recompute")
JCFG = {"tied": dataclasses.replace(TINY_QWEN2, vocab_size=128),
        "untied": dataclasses.replace(TINY_QWEN2, vocab_size=128, tie_word_embeddings=False)}
STAT_RTOL = 1e-5
LOGP_TOL = dict(atol=1e-5, rtol=1e-5)
WORLD_TIMEOUT = 150.0


class _Version:
    def get_version(self):
        return 0


def _wfn(d):
    return float((np.asarray(d["loss_mask"]) > 0).sum())


def _port_engine(mcfg, hf_dir, seed=0):
    cfg = tc.PPOActorConfig(path=hf_dir, optimizer=tc.OptimizerConfig(lr=LR, eps=ADAM_EPS),
                            adv_norm=tc.NormConfig(mean_level="group", std_level="batch", group_size=4), **COMMON)
    eng = TorchTrainEngine(cfg, model_config=mcfg, device="cpu")
    eng.initialize(FinetuneSpec(1, 128, 16), seed=seed)
    return eng


def _jax_engine(name, params, mesh: dict):
    jcfg = jc.PPOActorConfig(init_from_scratch=True, mesh=jc.MeshConfig(**mesh),
                             optimizer=jc.OptimizerConfig(lr=LR, eps=ADAM_EPS),
                             adv_norm=jc.NormConfig(mean_level="group", std_level="batch", group_size=4), **COMMON)
    eng = jte.JaxTrainEngine(jcfg, model_config=JCFG[name])
    n = int(np.prod(list(mesh.values())))
    eng.initialize(JFinetuneSpec(1, 128, 16), mesh=jmesh.make_mesh(jcfg.mesh, devices=jax.devices()[:n]))
    eng.params = jax.tree.map(lambda old, new: jax.device_put(jnp.asarray(new), old.sharding), eng.params, params)
    return jcfg, eng


def _jax_twin(name, params, mesh, fwd_batch, adv):
    jcfg, eng = _jax_engine(name, params, mesh)
    out = {"logp": eng.forward_batch(fwd_batch), "stats": []}
    for _ in range(2):
        out["stats"].append(eng.train_batch(adv, lambda o, b: jppo.grpo_loss_fn(o, b, jcfg), _wfn))
    out["params"] = {jax.tree_util.keystr(k): np.asarray(v)
                     for k, v in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, eng.params))}
    return out


def _setup(tmp_path, names):
    """Weights (JAX init, random norms and biases) written as the port's HF
    checkpoint per model, and the batches: the forward batch and a GRPO
    batch whose proximal logprobs and advantages the unsharded port made."""
    models, params = [], {}
    for name in names:
        params[name] = jax_params(JCFG[name], seed=3)
        mcfg = port_cfg(JCFG[name])
        hf_dir = str(tmp_path / f"hf_{name}")
        save_params_to_hf(convert.from_jax_params(params[name], mcfg), mcfg, hf_dir)
        models.append((name, hf_dir, mcfg))
    fwd_batch = jdata.pad_sequences_to_tensors(_trajs(8, seed=10, vocab=128))
    batch = jdata.pad_sequences_to_tensors(_trajs(8, seed=11, vocab=128))
    ref = _port_engine(models[0][2], models[0][1])
    batch["prox_logp"] = ref.forward_batch(batch)
    adv = tppo.PPOActor(ref.config, _Version()).compute_advantages(batch)
    payload = {"models": models, "actor": {"lr": LR, "eps": ADAM_EPS, "common": COMMON}, "fwd_batch": fwd_batch,
               "adv": adv}
    return payload, params


def _start(body, world, tmp_path, payload):
    work = tmp_path / body
    procs = child.start_world(body, world, work, payload)
    return lambda: child.join_world(procs, work, WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds and their JAX twins, side by side: the 4-rank world on
    tied and untied weights, the 2-rank world on tied weights, and the
    unsharded engine whose recover save the 2-rank world loads."""
    from concurrent.futures import ThreadPoolExecutor

    tmp = tmp_path_factory.mktemp("worlds")
    payload, params = _setup(tmp, ["tied", "untied"])
    name, hf_dir, mcfg = payload["models"][0]
    # an unsharded engine's recover save (two steps in: the moments set)
    uns = _port_engine(mcfg, hf_dir, seed=0)
    for _ in range(2):
        uns.train_batch(payload["adv"], lambda o, b: tppo.grpo_loss_fn(o, b, uns.config), _wfn)
    uns.save(SaveLoadMeta(path=str(tmp / "unsharded_ckpt"), weight_format="state", with_optim=True))
    fsdp_tp_mesh, data_mesh = dict(data=1, fsdp=2, model=2), dict(data=2, fsdp=1, model=1)
    join4 = _start("fsdp_tp_world", 4, tmp, {**payload, "mesh": fsdp_tp_mesh})
    join2 = _start("data_parallel_world", 2, tmp, {
        **payload, "models": payload["models"][:1], "mesh": data_mesh, "ckpt_dir": str(tmp / "ckpt"),
        "hf_out": str(tmp / "hf_out"), "unsharded_ckpt": str(tmp / "unsharded_ckpt"), "coord_batch": _coord_batch(),
        "root": str(tmp), "allocation_mode": "sglang:d1+fsdp:d2",
    })
    jobs = [(n, fsdp_tp_mesh) for n in params] + [("tied", data_mesh)]
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = [ex.submit(_jax_twin, n, params[n], m, payload["fwd_batch"], payload["adv"]) for n, m in jobs]
        want = [f.result() for f in futs]
    return {"fsdp_tp": (join4(), {"tied": want[0], "untied": want[1]}, payload),
            "data2": (join2(), {"tied": want[2]}, payload, uns, tmp)}


@pytest.fixture(scope="module")
def fsdp_tp(worlds):
    return worlds["fsdp_tp"]


@pytest.fixture(scope="module")
def data2(worlds):
    return worlds["data2"]


def _coord_batch():
    """``tests/multihost_child.py``'s host-0 rollout batch."""
    r = np.random.default_rng(7)
    lens = [5, 9, 13, 17, 11, 7]
    am = np.zeros((len(lens), max(lens)), bool)
    for i, n in enumerate(lens):
        am[i, :n] = True
    return {"seq_uid": np.arange(len(lens), dtype=np.int32),
            "input_ids": r.integers(1, 120, (len(lens), max(lens))).astype(np.int32),
            "attention_mask": am, "rewards": r.normal(0, 1, len(lens)).astype(np.float32)}


def _assert_params_twin(got: dict, want: dict, mcfg):
    flat_g = {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(
        convert.to_jax_params({n: torch.from_numpy(a) for n, a in got.items()}, mcfg))}
    assert flat_g.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_allclose(flat_g[key], w, err_msg=key, **PARAM_TOL)


def _assert_stats_twin(got: dict, want: dict):
    for step, (g, w) in enumerate(zip(got["stats"], want["stats"])):
        for k in ("loss", "grad_norm", "actor_loss", "n_valid_tokens"):
            np.testing.assert_allclose(g[k], w[k], rtol=STAT_RTOL, err_msg=f"step {step}: {k}")
        assert g["n_microbatches"] == w["n_microbatches"]
    assert want["stats"][1]["grad_norm"] > 0


# ---------------------------------------------------------------------------
# 4 ranks: fsdp=2 x model=2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tied", "untied"])
def test_fsdp_tp_forward_batch_matches_jax(fsdp_tp, name):
    ranks, want, _ = fsdp_tp
    for r in ranks:  # every rank returns the whole batch in global order
        np.testing.assert_allclose(r[name]["logp"], want[name]["logp"], **LOGP_TOL)


@pytest.mark.parametrize("name", ["tied", "untied"])
def test_fsdp_tp_train_steps_match_jax(fsdp_tp, name):
    ranks, want, _ = fsdp_tp
    for r in ranks:
        _assert_stats_twin(r[name], want[name])


def test_fsdp_tp_eval_batch_matches_unsharded(fsdp_tp):
    """``eval_batch`` on the mesh: the grid's stats combined over the row
    blocks equal the unsharded engine's (the port's twin of JAX's eval)."""
    ranks, _, payload = fsdp_tp
    name, hf_dir, mcfg = payload["models"][0]
    eng = _port_engine(mcfg, hf_dir)
    want = eng.eval_batch(payload["adv"], lambda o, b: tppo.grpo_loss_fn(o, b, eng.config), _wfn)
    for r in ranks:
        assert r[name]["eval"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(r[name]["eval"][k], v, rtol=STAT_RTOL, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", ["tied", "untied"])
def test_fsdp_tp_parameters_match_jax(fsdp_tp, name):
    ranks, want, payload = fsdp_tp
    mcfg = dict((n, c) for n, _, c in payload["models"])[name]
    _assert_params_twin(ranks[0][name]["params"], want[name]["params"], mcfg)
    assert all(r[name]["params"] == {} for r in ranks[1:])  # rank 0 alone keeps the gathered leaves


def test_fsdp_tp_local_heads_and_vocab_parallel(fsdp_tp):
    """Each rank computes 2 of the 4 heads; the vocab-parallel embedding is
    exact, its logprobs, entropy and their gradient (relative to its
    largest element) match the unsharded."""
    ranks, _, _ = fsdp_tp
    for r in ranks:
        assert r["tied"]["local_heads"] == 2
        vp = r["vocab_parallel"]
        assert vp["embed"] == 0.0
        assert vp["logp"] <= 1e-5 and vp["entropy"] <= 1e-5 and vp["dhidden"] <= 1e-5, vp


# ---------------------------------------------------------------------------
# 2 ranks: data=2
# ---------------------------------------------------------------------------


def test_data_parallel_twin_matches_jax(data2):
    ranks, want, payload, _, _ = data2
    for r in ranks:
        np.testing.assert_allclose(r["tied"]["logp"], want["tied"]["logp"], **LOGP_TOL)
        _assert_stats_twin(r["tied"], want["tied"])
    _assert_params_twin(ranks[0]["tied"]["params"], want["tied"]["params"], payload["models"][0][2])


def test_m2po_refused_over_data_parallel_ranks(data2):
    """M2PO's mask and token mean are the whole grid's, which a rank's block
    of rows does not see: ``use_m2po_loss`` over data x fsdp above 1 names
    item 6b on every rank."""
    ranks = data2[0]
    assert all(r["m2po"] is not None and "use_m2po_loss" in r["m2po"] and "6b" in r["m2po"] for r in ranks)


def test_checkpoint_across_mesh_shapes(data2):
    """A recover save on 2 ranks loads on one rank bit for bit, and the
    unsharded engine's save of it is the same bytes; an unsharded save loads
    on 2 ranks bit for bit; an engine on the mesh reloads its own save."""
    ranks, _, payload, uns, tmp = data2
    name, hf_dir, mcfg = payload["models"][0]
    assert all(r["reload_same"] for r in ranks)
    for n, t in uns.model.named_parameters():  # the unsharded save, read on the mesh
        np.testing.assert_array_equal(ranks[0]["loaded_unsharded"][n], t.detach().numpy(), err_msg=n)
    one = _port_engine(mcfg, hf_dir, seed=1)
    one.load(SaveLoadMeta(path=str(tmp / "ckpt"), weight_format="state", with_optim=True))
    for n, t in one.model.named_parameters():
        np.testing.assert_array_equal(t.detach().numpy(), ranks[0]["tied"]["params"][n], err_msg=n)
    one.save(SaveLoadMeta(path=str(tmp / "ckpt_again"), weight_format="state", with_optim=True))
    for f in ("params.safetensors", "mu.safetensors", "nu.safetensors", "manifest.json"):
        a = (tmp / "ckpt" / "state" / f).read_bytes()
        assert a == (tmp / "ckpt_again" / "state" / f).read_bytes(), f
    assert json.loads((tmp / "ckpt" / "state" / "manifest.json").read_text())["step_count"] == 2
    one.save(SaveLoadMeta(path=str(tmp / "hf_again"), weight_format="hf"))
    for f in os.listdir(tmp / "hf_out"):
        assert (tmp / "hf_out" / f).read_bytes() == (tmp / "hf_again" / f).read_bytes(), f
    # the weight push: the bytes rank 0 hands the stream are the unsharded engine's
    assert ranks[0]["push_bytes"] == bytes(RemoteTorchEngine._encode_bucket(list(one._export_params().items())))
    assert "push_bytes" not in ranks[1]


def test_rollout_coordinator(data2):
    """Rank 0 pulls; both ranks get its batch. JAX's coordinator hands
    process r ``redistribute(batch)[r]``: the same shards come from the
    batch every rank holds, and ``redistribute`` is JAX's."""
    ranks, _, _, _, _ = data2
    batch = _coord_batch()
    for r in ranks:
        assert r["coord"].keys() == batch.keys()
        for k, v in batch.items():
            np.testing.assert_array_equal(r["coord"][k], v)
            assert r["coord"][k].dtype == v.dtype
    for n_parts in (2, 3):
        for g, w in zip(tdr.redistribute(batch, n_parts), jdr.redistribute(batch, n_parts)):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])


def test_ppo_trainer_step_with_allocation_mode(data2):
    """One step of ``PPOTrainer.train`` under ``sglang:d1+fsdp:d2``: the
    actor on a 2-rank fsdp mesh, the server and the stats on rank 0 only,
    the server's weights the trainer's cast to bf16, version 1 everywhere."""
    ranks, _, _, _, _ = data2
    for rank, r in enumerate(ranks):
        ppo = r["ppo"]
        assert ppo["mesh"]["fsdp"] == 2 and ppo["mesh"]["data"] == 1
        assert ppo["version"] == 1
        assert ppo["lead_parts"] == (rank == 0)
        assert ppo["committed"] == (1 if rank == 0 else 0)
    assert ranks[0]["ppo"]["served_same"] and ranks[0]["ppo"]["server_version"] == 1


def test_sft_trainer_steps_with_allocation_mode(data2):
    """Two steps of ``SFTTrainer.train`` under ``fsdp:d2``: the engine on a
    2-rank fsdp mesh, the same losses on both ranks (the grid rows split,
    the stats combined), the stats logger on rank 0 only."""
    ranks, _, _, _, _ = data2
    for rank, r in enumerate(ranks):
        sft = r["sft"]
        assert sft["mesh"]["fsdp"] == 2 and sft["mesh"]["data"] == 1
        assert sft["version"] == 2 and len(sft["losses"]) == 2 and np.all(np.isfinite(sft["losses"]))
        assert sft["lead_parts"] == (rank == 0)
    assert ranks[0]["sft"]["losses"] == ranks[1]["sft"]["losses"]


# ---------------------------------------------------------------------------
# no spawn: the DSL, the mesh, the refusals, the forward scatter
# ---------------------------------------------------------------------------

DSL = ["d4t2p2", "sglang:d4t2+fsdp:d8", "sglang[r]:d2+fsdp[a]:d4|fsdp[c]:d4", "sglang:d4|fsdp:d4",
       "vllm:d2t2+megatron:(attn:d4t2|ffn:d2e4)", "d2et4e2", "fsdp:d2c4", "sglang:d2t4", "sglang:d1+fsdp:d2"]
BAD = ["", "x4", "d4+", "foo:d4", "sglang:", "d4d2", "(attn:d2)", "d4 |", "megatron:(attn:d4t2|ffn:d2e2)"]


def _fields(mode) -> dict:
    out = {"type": mode.type_.value}
    for k in ("gen", "train", "critic", "gen_backend", "train_backend", "gen_world_size", "train_world_size",
              "world_size"):
        v = getattr(mode, k)
        out[k] = repr(v).replace("areal_tpu_torch.", "").replace("areal_tpu.", "") if v is not None else None
    out["groups"] = [[(a.backend, a.name, repr(a.parallel), a.is_gen, a.is_train, a.world_size) for a in g]
                     for g in mode.groups]
    return out


@pytest.mark.parametrize("s", DSL)
def test_allocation_mode_parses_as_jax(s):
    assert _fields(tam.AllocationMode.from_str(s)) == _fields(jam.AllocationMode.from_str(s))


@pytest.mark.parametrize("s", BAD)
def test_allocation_mode_rejects_as_jax(s):
    with pytest.raises(ValueError):
        jam.AllocationMode.from_str(s)
    with pytest.raises(ValueError):
        tam.AllocationMode.from_str(s)


APPLY = [
    ("jax:d2t2+gspmd:d4c2t1", None),
    ("gspmd:d8", "actor"),  # an explicit mesh wins
    ("", None),
    ("gspmd[a]:d4|gspmd[c]:d2t2", "critic"),
    ("gspmd:(attn:d4t2|ffn:d2e4)", None),
    ("jax:(attn:d4t2|ffn:d2e4)+gspmd:d8", None),
    ("jax:d4e2+gspmd:d4e2", None),
    ("gspmd:d3e2", None),
]


@pytest.mark.parametrize("s, special", APPLY)
def test_apply_allocation_mode_as_jax(s, special):
    """``tests/test_alloc_mode.py``'s apply cases: the same meshes, server
    mesh and server count (or the same refusal)."""
    cfgs = []
    for pkg, apply in ((jc, jam.apply_allocation_mode), (tc, tam.apply_allocation_mode)):
        cfg = pkg.PPOConfig(allocation_mode=s)
        if special == "actor":
            cfg.actor.mesh = pkg.MeshConfig(data=2, fsdp=4)
        if special == "critic":
            cfg.critic = pkg.PPOCriticConfig()
        try:
            apply(cfg)
        except ValueError as e:
            cfgs.append(("raises", str(e)))
            continue
        cfgs.append([dataclasses.asdict(m) if m is not None else None for m in (
            cfg.actor.mesh, cfg.ref.mesh if cfg.ref else None, cfg.critic.mesh if cfg.critic else None,
            cfg.server.mesh)] + [cfg.launcher.n_servers])
    assert cfgs[0] == cfgs[1]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("mesh", [dict(), dict(data=1, fsdp=-1), dict(fsdp=2, model=2, data=-1), dict(data=2, fsdp=2),
                                  dict(model=4, data=-1)])
def test_mesh_sizes_as_jax(n, mesh):
    """The axis sizes (and the refusals) of ``make_mesh`` for n devices."""
    try:
        want = dict(jmesh.make_mesh(jc.MeshConfig(**mesh), devices=jax.devices()[:n]).shape)
    except AssertionError:
        with pytest.raises(ValueError):
            tmesh.mesh_sizes(tc.MeshConfig(**mesh), n)
        return
    assert tmesh.mesh_sizes(tc.MeshConfig(**mesh), n) == want
    assert tmesh.MESH_AXES == jmesh.MESH_AXES and tmesh.BATCH_AXES == jmesh.BATCH_AXES


@pytest.mark.parametrize("s, item", [
    ("sglang:d2+fsdp:d1", "item 8"),
    ("sglang:d1t2+fsdp:d2", None),  # tensor-parallel serving (item 6b-1)
    ("sglang:d1p2+fsdp:d2", "item 6b"),
    ("sglang:d1c2+fsdp:d2", "item 6b"),
    ("sglang:d2e2+fsdp:d2", None),  # one server on 2 cards, expert-parallel (item 6b-2a)
    ("sglang:d1+fsdp:d2c2", "item 6b"),
    ("sglang:d1+fsdp:d2p2", "item 6b"),
    ("sglang:d1+fsdp:d4e2", None),  # fsdp 2 x expert 2 (item 6b-2a)
    ("sglang:d1+megatron:(attn:d2t2|ffn:d2e2)", None),  # the hybrid MoE spec (item 6b-2a)
    ("sglang:d1+megatron:(attn:d2c2|ffn:d2e2)", "item 6b-3"),
    ("sglang:d1+fsdp:d4t2", None),
    ("fsdp:d2", None),
])
def test_allocation_refusals(s, item):
    """Item 7's matrix, without a spawn: each trainer refuses before it
    builds anything, naming the item the option waits for."""
    from areal_tpu_torch.trainer.rl_trainer import PPOTrainer, check_allocation
    from areal_tpu_torch.trainer.sft_trainer import SFTTrainer

    cfg = tc.PPOConfig(allocation_mode=s, weight_update_mode="mem", preemption=tc.PreemptionConfig(enabled=False))
    if item is None:
        check_allocation(cfg)
        return
    with pytest.raises(NotImplementedError, match=item):
        PPOTrainer(cfg, [{"prompt_ids": [1]}], rollout=object(), actor_engine=object())
    with pytest.raises(NotImplementedError, match=item):
        SFTTrainer(tc.SFTConfig(allocation_mode=s), [{"input_ids": [1], "loss_mask": [1]}], engine=object())


def test_engine_refusals_on_a_mesh():
    """``seq`` / ``pipe`` above 1 name items 6b-3 / 6b-4 at construction
    (``expert`` is ported: ``tests/test_torch_moe_mesh.py``); a mesh of more
    devices than the world (no world: one) raises at ``initialize``: there
    is no single-process fallback."""
    mcfg = port_cfg(JCFG["tied"])
    for axis in ("seq", "pipe"):
        with pytest.raises(NotImplementedError, match="6b"):
            TorchTrainEngine(tc.PPOActorConfig(mesh=tc.MeshConfig(**{axis: 2})), model_config=mcfg, device="cpu")
    eng = TorchTrainEngine(tc.PPOActorConfig(mesh=tc.MeshConfig(data=1, fsdp=2, model=2)), model_config=mcfg,
                          device="cpu")
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        eng.initialize()


def test_rollout_without_a_connected_engine_raises():
    """The trainer pulls every batch through the engine's coordinator; with
    no engine connected, a world of one raises too."""
    eng = TorchTrainEngine(tc.PPOActorConfig(), model_config=port_cfg(JCFG["tied"]), device="cpu")
    with pytest.raises(RuntimeError, match="no inference engine connected"):
        eng.prepare_batch(None)
    eng.connect_engine(None, None)
    with pytest.raises(RuntimeError, match="no inference engine connected"):
        eng.rollout_batch([])


def test_forward_batch_of_split_grids(tmp_path):
    """A ``forward_batch`` whose sequences re-pack into several grids
    (``max_tokens_per_mb``) returns every sequence on its own row: the same
    as one grid. JAX's ``forward_batch`` scatters a re-packed grid by its
    ``seq_index`` (``train_engine.py:1399``), which indexes the grid's
    sub-batch, not the input (ROADMAP Queue C, C-ref 11): JAX's own grids
    of this batch show the two apart."""
    from types import SimpleNamespace

    mcfg = port_cfg(JCFG["tied"])
    hf_dir = str(tmp_path / "hf")
    save_params_to_hf(convert.from_jax_params(jax_params(JCFG["tied"], seed=3), mcfg), mcfg, hf_dir)
    batch = jdata.pad_sequences_to_tensors(_trajs(8, seed=10, vocab=128))
    whole = _port_engine(mcfg, hf_dir)
    split = _port_engine(mcfg, hf_dir)
    split.config.mb_spec = tc.MicroBatchSpec(max_tokens_per_mb=128)
    assert len(split._make_grids(batch)) > 1
    np.testing.assert_allclose(split.forward_batch(batch), whole.forward_batch(batch), atol=1e-6)
    jeng = SimpleNamespace(config=SimpleNamespace(bucket_step=64, mb_spec=jc.MicroBatchSpec(max_tokens_per_mb=128)),
                           _dp=lambda: 1, _attach_image_embeds=lambda x: x)
    assert any(g.seq_index != g.source_index for g in jte.JaxTrainEngine._make_grids(jeng, batch))  # C-ref 11


def test_grid_rows_round_to_the_data_parallel_degree():
    """``_make_grids`` pads rows to the data-parallel degree as JAX's does
    (``train_engine.py:600``), and ``_grid_block`` splits them in
    ``batch_sharding``'s order; every sequence lands in exactly one block."""
    from types import SimpleNamespace

    batch = jdata.pad_sequences_to_tensors(_trajs(9, seed=4, vocab=128))
    for dp, mb in ((2, None), (4, None), (2, 128), (4, 200)):
        jeng = SimpleNamespace(config=SimpleNamespace(bucket_step=64, mb_spec=jc.MicroBatchSpec(max_tokens_per_mb=mb)),
                               _dp=lambda dp=dp: dp, _attach_image_embeds=lambda x: x)
        want = jte.JaxTrainEngine._make_grids(jeng, batch)
        teng = TorchTrainEngine(tc.PPOActorConfig(bucket_step=64, mb_spec=tc.MicroBatchSpec(max_tokens_per_mb=mb)),
                                model_config=port_cfg(JCFG["tied"]), device="cpu")
        teng._dp = lambda dp=dp: dp
        got = teng._make_grids(batch)
        assert [g.n_rows for g in got] == [g.n_rows for g in want] and all(g.n_rows % dp == 0 for g in got)
        for g, w in zip(got, want):
            for k in w.data:
                np.testing.assert_array_equal(g.data[k], w.data[k], err_msg=k)
            assert g.source_index == w.source_index
            seen = []
            for b in range(dp):
                blk = teng._grid_block(g, b)
                np.testing.assert_array_equal(blk.data["segment_ids"], g.data["segment_ids"][b * blk.n_rows:(b + 1) *
                                                                                            blk.n_rows])
                seen += blk.source_index
            assert sorted(seen) == sorted(g.source_index)
