"""The ranks of the port's CPU worlds (``tests/test_torch_parallel.py``):
``start_world`` spawns them, each joins a gloo world over a ``FileStore`` in
the test's own directory (no fixed port: xdist workers never collide), runs
one of the bodies below and pickles its result; a rank that raises writes
its traceback, and the world fails the test with it. This module imports
only the port (a spawned rank imports it and nothing of JAX)."""

from __future__ import annotations

import os
import pickle
import sys
import time
import traceback
from pathlib import Path

import numpy as np


def start_world(body: str, world: int, workdir: Path, payload: dict) -> list:
    """Spawn ``world`` ranks running ``body``; ``join_world`` collects them."""
    import multiprocessing as mp

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    # the payload goes by a file: a spawned child reads its arguments from a
    # pipe only once it has started, so arguments larger than the pipe's
    # buffer would hold each start until the child before it is up
    (workdir / "payload.pkl").write_bytes(pickle.dumps(payload))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_main, args=(body, r, world, str(workdir)), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_world(procs, workdir: Path, timeout: float) -> list:
    """The ranks' results by rank. A rank that fails, or a world that
    outlives ``timeout``, fails with every failing rank's traceback (the
    others are killed)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and any(p.is_alive() for p in procs):
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.05)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    errs = [(workdir / f"err{r}.txt") for r in range(len(procs))]
    msgs = [f"rank {r}:\n{e.read_text()}" for r, e in enumerate(errs) if e.exists()]
    if msgs or any(p.exitcode != 0 for p in procs):
        codes = [p.exitcode for p in procs]
        raise AssertionError(f"world failed (exit codes {codes}, timeout {timeout}s)\n" + "\n".join(msgs))
    return [pickle.loads((workdir / f"out{r}.pkl").read_bytes()) for r in range(len(procs))]


def _main(body: str, rank: int, world: int, workdir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        payload = pickle.loads(Path(workdir, "payload.pkl").read_bytes())
        store = dist.FileStore(os.path.join(workdir, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        out = globals()[body](rank, world, payload)
        Path(workdir, f"out{rank}.pkl").write_bytes(pickle.dumps(out))
        dist.barrier()
    except BaseException:  # noqa: BLE001 — the traceback is the test's failure message
        Path(workdir, f"err{rank}.txt").write_text(traceback.format_exc())
        sys.stdout.flush()
        os._exit(1)
    os._exit(0)  # a clean exit without tearing down the world's threads


# ---------------------------------------------------------------------------
# bodies
# ---------------------------------------------------------------------------


def _np(t):
    return t.detach().float().cpu().numpy()


def _engine(actor: dict, mesh: dict, path: str, mcfg, **engine_kw):
    from areal_tpu_torch.api.config import MeshConfig, NormConfig, OptimizerConfig, PPOActorConfig
    from areal_tpu_torch.api.io_struct import FinetuneSpec
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine

    cfg = PPOActorConfig(path=path, mesh=MeshConfig(**mesh), optimizer=OptimizerConfig(lr=actor["lr"], eps=actor["eps"]),
                         adv_norm=NormConfig(mean_level="group", std_level="batch", group_size=4),
                         **actor["common"])
    eng = TorchTrainEngine(cfg, model_config=mcfg, device="cpu", **engine_kw)
    eng.initialize(FinetuneSpec(1, 128, 16))
    return eng


def _train_twin(eng, p: dict) -> dict:
    """forward_batch and eval_batch, then two ``train_batch`` steps of the
    GRPO loss; the gathered parameters (rank 0)."""
    from areal_tpu_torch.trainer import ppo

    out = {"logp": eng.forward_batch(p["fwd_batch"]), "stats": []}
    out["eval"] = eng.eval_batch(p["adv"], lambda o, b: ppo.grpo_loss_fn(o, b, eng.config),
                                 lambda d: float((np.asarray(d["loss_mask"]) > 0).sum()))
    for _ in range(2):
        st = eng.train_batch(p["adv"], lambda o, b: ppo.grpo_loss_fn(o, b, eng.config),
                             lambda d: float((np.asarray(d["loss_mask"]) > 0).sum()))
        out["stats"].append({k: v for k, v in st.items() if isinstance(v, float)})
    out["seq_stats"] = eng.last_seq_stats
    out["params"] = {n: _np(t) for n, t in eng._export_params().items()}
    return out


def _vocab_parallel_checks(eng, mcfg, hf_dir: str) -> dict:
    """The vocab-parallel embedding and logprobs of a placed model against
    the unsharded port functions on the same weights: largest differences."""
    import torch

    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.models.hf import load_params_from_hf

    full, _ = load_params_from_hf(hf_dir, cfg=mcfg, device="cpu")
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, mcfg.vocab_size, (3, 17)).astype(np.int64))
    hidden = torch.from_numpy(rng.standard_normal((3, 17, mcfg.hidden_size)).astype(np.float32))

    def sharded(m):
        view = qwen.ShardedView(m, eng._local_cfg)
        emb = qwen._embed_lookup(view.embed, ids, torch.float32, view.tp)
        h = hidden.clone().requires_grad_(True)
        lp, ent = qwen.chunked_logprobs_entropy(view, h, ids, chunk_size=16)
        (lp.sum() + 0.5 * ent.sum()).backward()
        return emb, lp, ent, h.grad

    emb, lp, ent, dh = eng.model(sharded)
    eng.zero_grad()
    view = qwen.ParamView(full, mcfg)
    h = hidden.clone().requires_grad_(True)
    lp0, ent0 = qwen.chunked_logprobs_entropy(view, h, ids, chunk_size=16)
    (lp0.sum() + 0.5 * ent0.sum()).backward()
    emb0 = qwen._embed_lookup(view.embed, ids, torch.float32)
    return {"embed": float((emb - emb0).abs().max()), "logp": float((lp - lp0).detach().abs().max()),
            "entropy": float((ent - ent0).detach().abs().max()),
            "dhidden": float((dh - h.grad).abs().max() / h.grad.abs().max()), "dh_max": float(h.grad.abs().max())}


def fsdp_tp_world(rank: int, world: int, p: dict) -> dict:
    """The 4-rank world (fsdp=2, model=2): the twin of each model, and on
    the first the vocab-parallel checks."""
    out = {}
    for i, (name, hf_dir, mcfg) in enumerate(p["models"]):
        eng = _engine(p["actor"], p["mesh"], hf_dir, mcfg)
        if i == 0:
            out["vocab_parallel"] = _vocab_parallel_checks(eng, mcfg, hf_dir)
        out[name] = _train_twin(eng, p)
        out[name]["local_heads"] = eng._local_cfg.num_heads
    return out


class _Recorder:
    """An inference engine that keeps what ``update_weights`` hands it."""

    def __init__(self):
        self.pushed = None

    def update_weights(self, meta, params=None):
        self.pushed = params


def data_parallel_world(rank: int, world: int, p: dict) -> dict:
    """The 2-rank world (data=2): the twin, a recover save on the mesh and
    its load back, the weight push's bytes, the rollout coordinator, and
    one step of ``PPOTrainer.train`` over HTTP with the server on rank 0."""
    import torch

    from areal_tpu_torch.api.io_struct import SaveLoadMeta, WeightUpdateMeta
    from areal_tpu_torch.inference.client import RemoteTorchEngine

    name, hf_dir, mcfg = p["models"][0]
    eng = _engine(p["actor"], p["mesh"], hf_dir, mcfg)
    out = {name: _train_twin(eng, p)}
    # M2PO over two data-parallel ranks is refused at initialize
    try:
        _engine({**p["actor"], "common": {**p["actor"]["common"], "use_m2po_loss": True}}, p["mesh"], hf_dir, mcfg)
        out["m2po"] = None
    except NotImplementedError as e:
        out["m2po"] = str(e)
    # the recover state, written on the mesh (rank 0 writes)
    eng.save(SaveLoadMeta(path=p["ckpt_dir"], weight_format="state", with_optim=True))
    eng.save(SaveLoadMeta(path=p["hf_out"], weight_format="hf"))
    # ... and read back by a fresh engine on the mesh: the same leaves
    eng2 = _engine(p["actor"], p["mesh"], hf_dir, mcfg)
    eng2.load(SaveLoadMeta(path=p["ckpt_dir"], weight_format="state", with_optim=True))
    same = all(torch.equal(a.to_local(), b.to_local()) for a, b in zip(eng.model.parameters(), eng2.model.parameters()))
    same &= all(torch.equal(a, b) for a, b in zip(eng._opt.mu + eng._opt.nu, eng2._opt.mu + eng2._opt.nu))
    out["reload_same"] = bool(same) and eng2._opt.count == eng._opt.count
    # a load from an unsharded engine's files (written by the test)
    eng2.load(SaveLoadMeta(path=p["unsharded_ckpt"], weight_format="state", with_optim=True))
    out["loaded_unsharded"] = {n: _np(t) for n, t in eng2._export_params().items()}
    # the weight push: rank 0 hands the client the gathered leaves
    rec = _Recorder() if rank == 0 else None
    eng.connect_engine(rec, WeightUpdateMeta(type="mem"))
    eng.update_weights()
    if rank == 0:
        out["push_bytes"] = bytes(RemoteTorchEngine._encode_bucket(list(rec.pushed.items())))
    # the coordinator: rank 0 pulls, both ranks get the batch
    from areal_tpu_torch.infra.dist_rollout import DistRolloutCoordinator

    class _Rank0Only:
        def rollout_batch(self, data, workflow=None, **kw):
            assert rank == 0, "only rank 0 may consume"
            return {k: np.array(v, copy=True) for k, v in p["coord_batch"].items()}

    out["coord"] = DistRolloutCoordinator(_Rank0Only() if rank == 0 else None).rollout_batch([])
    out["ppo"] = _ppo_step(rank, p, mcfg, hf_dir)
    out["sft"] = _sft_steps(p, mcfg, hf_dir)
    return out


def _sft_steps(p: dict, mcfg, hf_dir: str) -> dict:
    """Two steps of ``SFTTrainer.train`` under ``allocation_mode="fsdp:d2"``
    on the same loader order on every rank."""
    from areal_tpu_torch.api import config as tc
    from areal_tpu_torch.api.alloc_mode import apply_allocation_mode
    from areal_tpu_torch.api.io_struct import FinetuneSpec
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine
    from areal_tpu_torch.trainer.sft_trainer import SFTTrainer

    root = os.path.join(p["root"], "sft")
    cfg = tc.SFTConfig(allocation_mode="fsdp:d2", total_train_steps=2, train_dataset=tc.DatasetConfig(batch_size=4),
                       model=tc.TrainEngineConfig(path=hf_dir, dtype="float32", param_dtype="float32", bucket_step=64,
                                                  optimizer=tc.OptimizerConfig(lr=p["actor"]["lr"])),
                       **{k: c(fileroot=root) for k, c in (("saver", tc.SaverConfig), ("checkpointer", tc.SaverConfig),
                                                           ("evaluator", tc.EvaluatorConfig),
                                                           ("recover", tc.RecoverConfig),
                                                           ("stats_logger", tc.StatsLoggerConfig))})
    cfg.cluster.fileroot = root
    apply_allocation_mode(cfg)  # the trainer applies it too; an engine built before it must see the mesh
    eng = TorchTrainEngine(cfg.model, model_config=mcfg, device="cpu")
    eng.initialize(FinetuneSpec(1, 8, 4))
    rng = np.random.default_rng(2)
    rows = [{"input_ids": rng.integers(1, mcfg.vocab_size, n).tolist(), "loss_mask": [0] * 3 + [1] * (n - 3)}
            for n in rng.integers(8, 40, 8)]
    trainer = SFTTrainer(cfg, rows, engine=eng)
    try:
        losses = trainer.train()
    finally:
        trainer.close()
    return {"mesh": dict(zip(eng.mesh.mesh_dim_names, eng.mesh.shape)), "losses": losses,
            "lead_parts": trainer.stats_logger is not None, "version": eng.get_version()}


def _even_share(prompt, completions, prompt_ids, completion_ids, **kw):
    return float(np.mean(np.asarray(completion_ids) % 2 == 0))


def _ppo_step(rank: int, p: dict, mcfg, hf_dir: str) -> dict:
    """One global step of ``PPOTrainer.train`` with ``allocation_mode`` set:
    the port's CPU server and the rollout client on rank 0 only."""
    import torch

    from areal_tpu_torch.api import config as tc
    from areal_tpu_torch.api.io_struct import GenerationHyperparameters
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine
    from areal_tpu_torch.inference.client import RemoteTorchEngine
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.inference.server import ServerThread
    from areal_tpu_torch.trainer.rl_trainer import PPOTrainer
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    root = os.path.join(p["root"], "ppo")
    acfg = tc.PPOActorConfig(path=hf_dir, optimizer=tc.OptimizerConfig(lr=p["actor"]["lr"], eps=p["actor"]["eps"]),
                             adv_norm=tc.NormConfig(mean_level="group", std_level="group", group_size=4),
                             **{**p["actor"]["common"], "ppo_n_minibatches": 1})
    gconfig = GenerationHyperparameters(n_samples=4, max_new_tokens=6, temperature=1.0)
    cfg = tc.PPOConfig(allocation_mode=p["allocation_mode"], total_train_steps=1, weight_update_mode="mem",
                       gconfig=gconfig, train_dataset=tc.DatasetConfig(batch_size=2), actor=acfg,
                       preemption=tc.PreemptionConfig(enabled=False),
                       **{k: c(fileroot=root) for k, c in (("saver", tc.SaverConfig), ("checkpointer", tc.SaverConfig),
                                                           ("evaluator", tc.EvaluatorConfig),
                                                           ("recover", tc.RecoverConfig),
                                                           ("stats_logger", tc.StatsLoggerConfig))})
    cfg.cluster.fileroot = root
    eng = TorchTrainEngine(cfg.actor, model_config=mcfg, device="cpu")  # sized by allocation_mode in the trainer
    srv = client = None
    if rank == 0:
        scfg = tc.ServerConfig(max_batch_size=8, max_seq_len=64, decode_steps_per_call=4, seed=0, host="127.0.0.1")
        from areal_tpu_torch.models.hf import load_params_from_hf

        full, _ = load_params_from_hf(hf_dir, cfg=mcfg, device="cpu")
        srv = ServerThread(scfg, engine=DecodeEngine(scfg, params=full.state_dict(), model_cfg=mcfg, device="cpu"))
        srv.start()
        client = RemoteTorchEngine(tc.InferenceEngineConfig(max_concurrent_rollouts=8, consumer_batch_size=2,
                                                            max_head_offpolicyness=1, request_timeout=60),
                                   addresses=[srv.address])
        client.initialize()
    rng = np.random.default_rng(0)
    dataset = [{"prompt_ids": rng.integers(20, 100, 4).tolist()} for _ in range(8)]
    trainer = PPOTrainer(cfg, dataset, rollout=client, actor_engine=eng)
    committed = []
    if trainer.stats_logger is not None:
        trainer.stats_logger.commit = lambda epoch, step, gstep, stats: committed.append(stats)
    try:
        trainer.train(workflow=RLVRWorkflow(_even_share, gconfig))
        out = {"mesh": dict(zip(eng.mesh.mesh_dim_names, eng.mesh.shape)), "version": eng.get_version(),
               "committed": len(committed), "lead_parts": trainer.stats_logger is not None}
        params = eng._export_params()
        if rank == 0:
            served = dict(srv.engine.model.named_parameters())
            out["served_same"] = all(torch.equal(t.to(torch.bfloat16).float(), served[n].detach().float())
                                     for n, t in params.items())
            out["server_version"] = srv.engine.get_version()
            client.pause()
    finally:
        trainer.close()
        if srv is not None:
            srv.stop()
    return out


def _moe_ffn_cases(p: dict) -> dict:
    """``moe_ffn`` on each of ``p["meshes"]``, dropless and capacity: this
    rank's slice of one MoE layer (``qwen.tp_slice``), its block of the
    rows, out and aux, and the backward of sum(out * ct) + coef * aux (the
    aux share of a block's loss is 1 / dp, as the engine's loss weights
    make it): the rows' dh and the leaves' gradients summed over the batch
    axes (FSDP's reduce)."""
    import dataclasses
    from types import SimpleNamespace

    import torch

    from areal_tpu_torch.api.config import MeshConfig
    from areal_tpu_torch.models import moe, qwen
    from areal_tpu_torch.parallel import mesh as mesh_lib
    from areal_tpu_torch.parallel import tensor_parallel as tp_lib

    cfg = p["cfg"]
    specs = qwen.param_partition_specs(cfg)
    h_all, ct_all = torch.from_numpy(p["h"]), torch.from_numpy(p["ct"])
    out = {}
    for name, kw in p["meshes"].items():
        replicas = kw.pop("replicas", False)  # the data axis holds copies of one block (an expert-only case)
        mesh = mesh_lib.make_mesh(MeshConfig(**kw), "cpu")
        m, e = mesh_lib.axis_size(mesh, "model"), mesh_lib.ep_size(mesh)
        tr, er = mesh.get_local_rank("model"), mesh_lib.ep_rank(mesh)
        dp, b = (1, 0) if replicas else (mesh_lib.dp_size(mesh), mesh_lib.dp_rank(mesh))
        tp = tp_lib.TPInfo(group=mesh.get_group("model") if m > 1 else None, rank=tr, size=m, vocab_start=0)
        dp_groups = () if replicas else tuple(mesh.get_group(a) for a in mesh_lib.BATCH_AXES
                                              if mesh_lib.axis_size(mesh, a) > 1)
        ep = tp_lib.EPInfo(group=mesh.get_group("expert") if e > 1 else None, rank=er, size=e, dp_groups=dp_groups,
                           dp_size=dp)
        rows = slice(b * h_all.shape[0] // dp, (b + 1) * h_all.shape[0] // dp)
        for path in ("dropless", "capacity"):
            c = dataclasses.replace(cfg, moe_dropless=path == "dropless")
            leaves = {n: qwen.tp_slice(torch.from_numpy(a), specs[n], m, tr, e, er).clone().requires_grad_(True)
                      for n, a in p["layer"].items()}
            h = h_all[rows].clone().requires_grad_(True)
            o, aux = moe.moe_ffn(h, SimpleNamespace(**leaves, tp=tp, ep=ep), c, with_aux=True)
            ((o * ct_all[rows]).sum() + p["coef"] * aux / dp).backward()
            grads = {}
            for n, t in leaves.items():
                g = t.grad.clone()
                if not replicas:
                    mesh_lib.all_reduce(g, mesh, mesh_lib.BATCH_AXES)
                grads[n] = g.numpy()
            out[f"{name}/{path}"] = dict(out=_np(o), aux=float(aux), dh=_np(h.grad), grads=grads, at=(tr, er, b, dp),
                                         local_experts=leaves["we_gate"].shape[0])
    return out


def _expert_grads_equal(eng, p: dict) -> float:
    """One ``compute_grads`` of the GRPO loss: the largest difference
    between the expert ranks' gradient shards of every leaf that is not
    split over ``expert`` (they must be equal: nothing reduces over it)."""
    import torch

    from areal_tpu_torch.engine.train_engine import _local
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.trainer import ppo

    eng.compute_grads(p["adv"], lambda o, b: ppo.grpo_loss_fn(o, b, eng.config),
                      lambda d: float((np.asarray(d["loss_mask"]) > 0).sum()))
    group = eng.model.ep.group
    worst = 0.0
    for n, prm in eng.model.named_parameters():
        if qwen.mesh_dim(eng.model_cfg, n, "expert") is not None:
            continue
        g = _local(prm.grad).contiguous()
        parts = [torch.empty_like(g) for _ in range(eng.model.ep.size)]
        torch.distributed.all_gather(parts, g, group=group)
        worst = max(worst, max(float((q - parts[0]).abs().max()) for q in parts))
    eng.zero_grad()
    return worst


def moe_mesh_world(rank: int, world: int, p: dict) -> dict:
    """The 4-rank world of ``tests/test_torch_moe_mesh.py``: the MoE FFN on
    three meshes (``_moe_ffn_cases``), then the engine on fsdp=2 x expert=2:
    the trainer twin, the non-expert gradients equal over ``expert``, a
    recover save and an HF export on the mesh, and the load of an unsharded
    engine's save."""
    import torch

    from areal_tpu_torch.api.io_struct import SaveLoadMeta

    out = {"ffn": _moe_ffn_cases(p)}
    name, hf_dir, mcfg = p["models"][0]
    eng = _engine(p["actor"], p["mesh"], hf_dir, mcfg)
    out["local_experts"] = eng._local_cfg.num_experts
    out["full_params"] = sum(int(np.prod(eng._full_shape(n))) for n, _ in eng.model.named_parameters())
    out["expert_grad_diff"] = _expert_grads_equal(eng, p)
    out["twin"] = _train_twin(eng, p)
    eng.save(SaveLoadMeta(path=p["ckpt_dir"], weight_format="state", with_optim=True))
    eng.save(SaveLoadMeta(path=p["hf_out"], weight_format="hf"))
    eng2 = _engine(p["actor"], p["mesh"], hf_dir, mcfg)
    eng2.load(SaveLoadMeta(path=p["ckpt_dir"], weight_format="state", with_optim=True))
    same = all(torch.equal(a.to_local(), b.to_local()) for a, b in zip(eng.model.parameters(), eng2.model.parameters()))
    same &= all(torch.equal(a, b) for a, b in zip(eng._opt.mu + eng._opt.nu, eng2._opt.mu + eng2._opt.nu))
    out["reload_same"] = bool(same) and eng2._opt.count == eng._opt.count
    eng2.load(SaveLoadMeta(path=p["unsharded_ckpt"], weight_format="state", with_optim=True))
    out["loaded_unsharded"] = {n: _np(t) for n, t in eng2._export_params().items()}
    return out
