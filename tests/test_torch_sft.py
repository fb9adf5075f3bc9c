"""The SFT and reward-model trainers against the JAX package on the CPU
(``areal_tpu_torch/trainer/sft_trainer.py`` against
``areal_tpu/trainer/sft_trainer.py``): the twins of ``tests/test_sft_rw.py``
and of the SFT phase breakdown of ``tests/test_step_timeline.py``, the
frozen loss curve, ``rw_loss_fn`` on a packed grid and the reward model's
split. Both sides start from the same weights: a one-device
``JaxTrainEngine``'s, carried into the port by ``models/convert.py``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api import config as jc
from areal_tpu.api.io_struct import FinetuneSpec as JFinetuneSpec
from areal_tpu.engine.train_engine import JaxTrainEngine
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu.trainer import sft_trainer as jsft
from areal_tpu.utils import data as jdata
from areal_tpu.utils import grid as jgrid
from areal_tpu_torch.api import config as tc
from areal_tpu_torch.api.io_struct import FinetuneSpec
from areal_tpu_torch.engine.train_engine import TorchTrainEngine
from areal_tpu_torch.models import convert
from areal_tpu_torch.observability.step_timeline import PHASES
from areal_tpu_torch.trainer import sft_trainer as tsft

from test_torch_qwen import port_cfg
from tpu_testing import TINY_QWEN2

MCFG = port_cfg(TINY_QWEN2)
FROZEN_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_sft_rw.py's tolerance on the frozen curve
# the port's curve against JAX's from the same weights and rows (f32 on the
# CPU: summation order, compounding over the steps)
CURVE_TOL = dict(rtol=1e-4, atol=1e-5)
RW_TOL = dict(rtol=1e-5, atol=1e-6)  # rw_loss_fn on one grid


def _engine_kw(pkg, **over) -> dict:
    kw = dict(
        init_from_scratch=True,
        dtype="float32",
        param_dtype="float32",
        optimizer=pkg.OptimizerConfig(lr=1e-2, lr_scheduler_type="constant"),
        mb_spec=pkg.MicroBatchSpec(max_tokens_per_mb=4096),
        bucket_step=64,
    )
    if pkg is jc:
        kw["mesh"] = jc.MeshConfig(data=1)
    kw.update(over)
    return kw


def _engines(n_rows: int, value_head: bool = False, **over) -> tuple[JaxTrainEngine, TorchTrainEngine]:
    """A JAX engine on one CPU device at its own seeded init, and the port's
    engine on the CPU with the same weights."""
    jcfg = jc.TrainEngineConfig(**_engine_kw(jc, **over))
    jeng = JaxTrainEngine(jcfg, model_config=TINY_QWEN2, value_head=value_head)
    jeng.initialize(JFinetuneSpec(1, n_rows, 8), mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    teng = TorchTrainEngine(tc.TrainEngineConfig(**_engine_kw(tc, **over)), model_config=MCFG,
                            value_head=value_head, device="cpu")
    teng.initialize(FinetuneSpec(1, n_rows, 8))
    teng.model.load_state_dict(convert.from_jax_params(jax.tree.map(np.asarray, jeng.params), MCFG))
    return jeng, teng


def _sft_rows(n: int, seed: int) -> list[dict]:
    """tests/test_sft_rw.py's rows: a prompt, then a response that always
    repeats token 42 under the loss mask."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        p = int(rng.integers(3, 8))
        ids = np.concatenate([rng.integers(1, 250, p), np.full(6, 42)]).astype(np.int32)
        lm = np.concatenate([np.zeros(p), np.ones(6)]).astype(np.float32)
        rows.append({"input_ids": ids.tolist(), "loss_mask": lm.tolist()})
    return rows


def _sft_cfg(pkg, root: str, name: str, epochs: int, batch_size: int, shuffle: bool = True):
    cls = pkg.SFTConfig
    cfg = cls(
        experiment_name=name,
        trial_name="t0",
        total_train_epochs=epochs,
        model=pkg.TrainEngineConfig(**_engine_kw(pkg)),
        train_dataset=pkg.DatasetConfig(batch_size=batch_size, shuffle=shuffle),
        saver=pkg.SaverConfig(fileroot=root),
        checkpointer=pkg.SaverConfig(fileroot=root),
        recover=pkg.RecoverConfig(mode="disabled", fileroot=root),
        stats_logger=pkg.StatsLoggerConfig(fileroot=root),
    )
    cfg.cluster.fileroot = root
    return cfg


def _train_both(tmp_path, rows, name: str, epochs: int, batch_size: int = 8, shuffle: bool = True):
    jeng, teng = _engines(len(rows))
    jl = jsft.SFTTrainer(_sft_cfg(jc, str(tmp_path / "jax"), name, epochs, batch_size, shuffle), rows,
                         engine=jeng).train()
    tr = tsft.SFTTrainer(_sft_cfg(tc, str(tmp_path / "port"), name, epochs, batch_size, shuffle), rows,
                         engine=teng)
    tl = tr.train()
    tr.close()
    return np.asarray(jl, np.float64), np.asarray(tl, np.float64)


def test_sft_trainer_loss_decreases_as_jax(tmp_path):
    """The twin of ``test_sft_rw.py::test_sft_trainer_loss_decreases``: the
    loss falls by more than 2 nats over 3 epochs, step by step as JAX's."""
    want, got = _train_both(tmp_path, _sft_rows(32, 0), "sft", epochs=3)
    assert len(got) == len(want) == 12
    assert got[-1] < got[0] - 2.0, (got[0], got[-1])
    np.testing.assert_allclose(got, want, **CURVE_TOL)


def test_sft_frozen_loss_curve(tmp_path):
    """The port's ``SFTTrainer`` from the JAX engine's initial weights
    reproduces ``tests/ref_losses_sft.json`` at that test's tolerance, and
    JAX's own curve from the same rows step by step."""
    want, got = _train_both(tmp_path, _sft_rows(16, 1), "sft-frozen", epochs=2, shuffle=False)
    with open(os.path.join(os.path.dirname(__file__), "ref_losses_sft.json")) as f:
        ref = json.load(f)
    assert len(got) == len(ref) == len(want)
    np.testing.assert_allclose(got, ref, **FROZEN_TOL)
    np.testing.assert_allclose(got, want, **CURVE_TOL)


def test_sft_trainer_phase_breakdown(tmp_path):
    """The twin of ``test_step_timeline.py::test_sft_trainer_phase_breakdown``:
    every step's phases and other_s sum to its total, no rollout wait or
    bubble, a forward / backward span, and the memory ledger."""
    rng = np.random.default_rng(0)
    rows = [{"input_ids": rng.integers(1, 250, 10).astype(np.int32).tolist(), "loss_mask": [1.0] * 10}
            for _ in range(8)]
    _, teng = _engines(len(rows))
    tr = tsft.SFTTrainer(_sft_cfg(tc, str(tmp_path), "sft-obs", 1, 4), rows, engine=teng)
    tr.train()
    recent = tr.step_recorder.recent()
    assert len(recent) == 2
    for rec in recent:
        bd = rec["breakdown"]
        assert abs(sum(bd[f"{p}_s"] for p in PHASES) + bd["other_s"] - bd["total_s"]) < 1e-9, bd
        assert bd["rollout_wait_s"] == 0.0 and bd["bubble_fraction"] == 0.0
        assert bd["forward_backward_s"] > 0.0
    assert tr.last_hbm_ledger is not None and tr.last_hbm_ledger["components"]["params"] > 0
    tr.close()


def test_sft_eval_pass_matches_jax(tmp_path):
    """``_run_eval``: the token-weighted eval loss under ``eval/``, as
    JAX's, after one step."""
    from areal_tpu.utils import stats_tracker as j_stats
    from areal_tpu_torch.utils import stats_tracker as t_stats

    rows, valid = _sft_rows(8, 2), _sft_rows(6, 3)
    jeng, teng = _engines(len(rows))
    out = {}
    for pkg, mod, eng, st in ((jc, jsft, jeng, j_stats), (tc, tsft, teng, t_stats)):
        st.export_all()
        cfg = _sft_cfg(pkg, str(tmp_path / pkg.__name__), "sft-eval", 1, 8)
        cfg.evaluator = pkg.EvaluatorConfig(fileroot=str(tmp_path), freq_steps=1)
        tr = mod.SFTTrainer(cfg, rows, valid_dataset=valid, engine=eng)
        committed = []
        tr.stats_logger.commit = lambda epoch, step, gstep, stats: committed.append(stats)
        tr.train()
        out[pkg] = committed[-1]["eval/ppl_loss"]
    assert np.isfinite(out[tc]) and out[tc] > 0
    np.testing.assert_allclose(out[tc], out[jc], **CURVE_TOL)


# ---------------------------------------------------------------------------
# the reward model
# ---------------------------------------------------------------------------


def _pref_batch(seed: int, n_pairs: int = 8) -> dict:
    """Chosen sequences end with token 9, rejected with token 3, after the
    same prompt (tests/test_sft_rw.py)."""
    r = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_pairs):
        p = r.integers(1, 250, int(r.integers(4, 10))).astype(np.int32)
        for last in (9, 3):
            ids = np.concatenate([p, [last]]).astype(np.int32)
            seqs.append({"input_ids": ids, "loss_mask": np.ones(len(ids), np.float32)})
    return jdata.pad_sequences_to_tensors(seqs)


def test_rw_engine_learns_preference_as_jax():
    """The twin of ``test_sft_rw.py::test_rw_engine_learns_preference``:
    accuracy above 0.9 and a falling loss after 12 batches, each step's
    loss, accuracy and pair count as JAX's."""
    jeng, teng = _engines(64, value_head=True)
    jrw, trw = jsft.RWEngine(jeng), tsft.RWEngine(teng)
    got, want = [], []
    for i in range(12):
        batch = _pref_batch(i)
        want.append(jrw.train_rw(batch)[0])
        got.append(trw.train_rw(batch)[0])
    assert got[-1]["rw_acc"] > 0.9, (got[0], got[-1])
    assert got[-1]["rw_loss"] < got[0]["rw_loss"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["n_pairs"] == w["n_pairs"] == 8
        np.testing.assert_allclose(g["rw_loss"], w["rw_loss"], **CURVE_TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(g["rw_acc"], w["rw_acc"], atol=1e-6, err_msg=f"step {i}")


def test_rw_loss_fn_on_a_packed_grid_matches_jax():
    """Several pairs per grid row (64-token rows of 5-16-token sequences),
    the padding's pair id 0: the loss, ``rw_acc`` and ``n_pairs`` as JAX's
    ``segment_sum`` version gives them."""
    rng = np.random.default_rng(7)
    seqs = []
    for _ in range(9):
        p = rng.integers(1, 250, int(rng.integers(4, 15))).astype(np.int32)
        for last in (9, 3):
            seqs.append({"input_ids": np.concatenate([p, [last]]).astype(np.int32),
                         "loss_mask": np.ones(len(p) + 1, np.float32)})
    mb = jsft.RWEngine(None)._prep(jdata.pad_sequences_to_tensors(seqs))
    grid = jgrid.pack_grid(mb, row_len=64)
    assert grid.n_rows < len(seqs) // 2  # pairs share rows
    b = {k: grid.data[k] for k in ("rw_pair_id", "rw_sign", "rw_last_mask")}
    assert np.all(b["rw_pair_id"][grid.data["segment_ids"] == 0] == 0)
    values = rng.normal(0, 1, grid.data["segment_ids"].shape).astype(np.float32)
    jl, js = jsft.rw_loss_fn({"values": jnp.asarray(values)}, {k: jnp.asarray(v) for k, v in b.items()})
    tl, ts = tsft.rw_loss_fn({"values": torch.from_numpy(values)}, {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(ts["n_pairs"]) == float(js["n_pairs"]) == 9
    assert 0 < float(ts["rw_acc"]) < 1
    np.testing.assert_allclose(float(tl), float(jl), **RW_TOL)
    for k in ("rw_loss", "rw_acc"):
        np.testing.assert_allclose(float(ts[k]), float(js[k]), **RW_TOL, err_msg=k)


def test_rw_split_strands_no_pair():
    """A ``max_tokens_per_mb`` that forces several microbatches: each keeps
    its pairs whole (``n_pairs`` sums to the batch's pairs), as JAX's
    split does, with the same per-microbatch stats."""
    jeng, teng = _engines(64, value_head=True)
    spec = dict(max_tokens_per_mb=64)
    batch = _pref_batch(20, n_pairs=12)
    want = jsft.RWEngine(jeng, jc.MicroBatchSpec(**spec)).train_rw(batch)
    got = tsft.RWEngine(teng, tc.MicroBatchSpec(**spec)).train_rw(batch)
    assert len(got) == len(want) > 1
    assert sum(s["n_pairs"] for s in got) == 12
    for g, w in zip(got, want):
        assert g["n_pairs"] == w["n_pairs"]
        np.testing.assert_allclose(g["rw_loss"], w["rw_loss"], **CURVE_TOL)


def _pref_rows(n: int, seed: int) -> list[dict]:
    r = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        p = r.integers(1, 250, int(r.integers(4, 10))).astype(np.int32)
        rows.append({"chosen_ids": np.r_[p, 9].tolist(), "rejected_ids": np.r_[p, 3].tolist()})
    return rows


def test_rw_trainer_matches_jax(tmp_path):
    """``RWTrainer`` on the ``SFTTrainer`` harness, 4 steps of 8 pairs over
    microbatches of 64 tokens: the pair-weighted step stats and the losses
    as JAX's, ``n_pairs`` the step's pairs; a validation set is refused."""
    rows = _pref_rows(32, 3)
    jeng, teng = _engines(len(rows), value_head=True)
    out = {}
    for pkg, mod, eng in ((jc, jsft, jeng), (tc, tsft, teng)):
        cfg = pkg.RWConfig(**{f: getattr(_sft_cfg(pkg, str(tmp_path / pkg.__name__), "rw", 1, 8), f)
                              for f in ("experiment_name", "trial_name", "total_train_epochs", "train_dataset",
                                        "saver", "checkpointer", "recover", "stats_logger", "cluster")})
        cfg.model = pkg.TrainEngineConfig(**_engine_kw(pkg, mb_spec=pkg.MicroBatchSpec(max_tokens_per_mb=64)))
        tr = mod.RWTrainer(cfg, rows, engine=eng)
        steps = []
        real = tr._train_step
        tr._train_step = lambda batch: steps.append(real(batch)) or steps[-1]
        losses = tr.train()
        out[pkg] = (losses, steps)
    (jl, js), (tl, ts) = out[jc], out[tc]
    assert len(tl) == len(jl) == 4
    assert [s["n_pairs"] for s in ts] == [s["n_pairs"] for s in js] == [8.0] * 4
    np.testing.assert_allclose(tl, jl, **CURVE_TOL)
    for g, w in zip(ts, js):
        np.testing.assert_allclose(g["rw_acc"], w["rw_acc"], atol=1e-6)
    with pytest.raises(ValueError, match="no eval loop"):
        tsft.RWTrainer(tc.RWConfig(), rows, valid_dataset=rows, engine=teng)
