"""The port's entry scripts (``areal_tpu_torch/examples``) on the CPU: GRPO,
SFT and RW from the example YAML files as written (plus the step count and
where files go), nothing left running after them, and the SFT row
tokenizer and the greedy eval held against the JAX package's scripts."""

import dataclasses
import functools
import importlib.util
import math
import signal
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import areal_tpu.dataset as jd
import areal_tpu_torch.dataset as td
from areal_tpu_torch.examples.alignment import hhrlhf_rw
from areal_tpu_torch.examples.math import gsm8k_eval, gsm8k_rl, gsm8k_sft
from areal_tpu_torch.models import qwen
from areal_tpu_torch.models.hf import save_params_to_hf
from areal_tpu_torch.utils import stats_logger

ROOT = Path(__file__).resolve().parent.parent
SMOKE = ROOT / "examples" / "smoke"
SIGNALS = (signal.SIGTERM, signal.SIGUSR1, signal.SIGUSR2)


def _files_under(root) -> list[str]:
    """Overrides that send every file the entry writes under ``root``."""
    return [f"{k}.fileroot={root}" for k in ("cluster", "saver", "checkpointer", "evaluator", "recover",
                                             "stats_logger")]


def _load_jax_example(name: str, monkeypatch):
    """A JAX example script as a module (it imports ``common`` by path)."""
    monkeypatch.syspath_prepend(str(ROOT / "examples" / "math"))
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", ROOT / "examples" / "math" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def nothing_left():
    """Asserts that the test leaves no thread and no signal handler behind."""
    threads = set(threading.enumerate())
    handlers = {s: signal.getsignal(s) for s in SIGNALS}
    yield
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:  # pool workers finish their shutdown asynchronously
        left = [t.name for t in set(threading.enumerate()) - threads if t.is_alive()]
        if not left:
            break
        time.sleep(0.05)
    assert not left, f"threads left running: {left}"
    assert {s: signal.getsignal(s) for s in SIGNALS} == handlers


@pytest.fixture
def committed(monkeypatch):
    """The stats ``PPOTrainer`` commits each step."""
    out = []
    commit = stats_logger.StatsLogger.commit

    def commit_logged(self, epoch, step, global_step, data):
        out.append(dict(data))
        return commit(self, epoch, step, global_step, data)

    monkeypatch.setattr(stats_logger.StatsLogger, "commit", commit_logged)
    return out


def test_entry_modules_under_the_port_rules():
    """The entry layer keeps its own YAML reader, config loader, dataset
    registry and scripts inside the package, so the import rule of
    ``tests/test_torch_port_rules.py`` (no JAX, no ``areal_tpu``, no yaml)
    covers them."""
    from test_torch_port_rules import FORBIDDEN_ROOTS, PORT_FILES, _imported_modules

    entry = ["utils/yaml_subset.py", "api/config.py", "dataset/__init__.py", "examples/math/common.py",
             "examples/math/gsm8k_rl.py", "examples/math/gsm8k_sft.py", "examples/math/gsm8k_eval.py",
             "examples/alignment/hhrlhf_rw.py", "inference/server.py"]
    paths = [ROOT / "areal_tpu_torch" / e for e in entry]
    assert set(paths) <= set(PORT_FILES)
    for p in paths:
        assert not [m for m in _imported_modules(p) if m.split(".")[0] in FORBIDDEN_ROOTS], p


def test_grpo_entry_runs_the_smoke_yaml(tmp_path, monkeypatch, committed, nothing_left):
    monkeypatch.delenv("AREAL_TPU_SERVER_ADDRS", raising=False)
    trainer = gsm8k_rl.main(["--config", str(SMOKE / "synthetic_grpo.yaml"), "total_train_steps=2",
                             *_files_under(tmp_path)], device="cpu")
    assert [int(d["version"]) for d in committed] == [1, 2]
    assert all(math.isfinite(d["ppo_actor/loss"]) for d in committed)
    assert trainer.actor_engine.get_version() == 2 and trainer.actor_engine.device.type == "cpu"
    assert trainer.weight_update_meta.type == "mem"  # the single-host stack's update mode


def test_grpo_entry_cleans_up_when_it_raises(tmp_path, monkeypatch, nothing_left):
    """The rollout client refuses a routing policy after the server started:
    the server stops and the handlers come back all the same."""
    monkeypatch.delenv("AREAL_TPU_SERVER_ADDRS", raising=False)
    with pytest.raises(NotImplementedError, match="item 8"):
        gsm8k_rl.main(["--config", str(SMOKE / "synthetic_grpo.yaml"), "rollout.routing_policy=least_loaded",
                       *_files_under(tmp_path)], device="cpu")


def test_grpo_entry_refuses_a_fleet(tmp_path, monkeypatch, nothing_left):
    monkeypatch.setenv("AREAL_TPU_SERVER_ADDRS", "127.0.0.1:1,127.0.0.1:2")
    with pytest.raises(NotImplementedError, match="item 8"):
        gsm8k_rl.main(["--config", str(SMOKE / "synthetic_grpo.yaml"), *_files_under(tmp_path)], device="cpu")


class _ChatTokenizer:
    """What ``tokenize_sft_rows`` reads of a tokenizer."""

    eos_token_id = 2

    @staticmethod
    def apply_chat_template(messages, add_generation_prompt=True, tokenize=True):
        return [3] + [ord(c) % 50 + 4 for m in messages for c in m["content"]]

    @staticmethod
    def encode(text, add_special_tokens=False):
        return [ord(c) % 50 + 4 for c in text]


@pytest.mark.parametrize("tokenizer,max_len", [(None, None), (_ChatTokenizer(), None), (_ChatTokenizer(), 24)],
                         ids=["char-level", "chat-template", "chat-template-cut"])
def test_tokenize_sft_rows_twin(tokenizer, max_len, monkeypatch):
    jax_sft = _load_jax_example("gsm8k_sft", monkeypatch)
    rows = jd.get_custom_dataset("synthetic_arith", n=16, seed=4)
    if tokenizer is not None:
        rows = [{**r, "messages": [{"role": "user", "content": r["prompt"]}]} for r in rows]
    want = jax_sft.tokenize_sft_rows(rows, tokenizer, max_len)
    got = gsm8k_sft.tokenize_sft_rows(rows, tokenizer, max_len)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])


def test_sft_entry_runs_the_smoke_yaml(tmp_path, nothing_left):
    losses = gsm8k_sft.main(["--config", str(SMOKE / "synthetic_sft.yaml"), "total_train_steps=2",
                             *_files_under(tmp_path)], device="cpu")
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)


def test_rw_entry_runs_on_the_tiny_model(tmp_path, nothing_left):
    losses = hhrlhf_rw.main(["--config", str(ROOT / "examples/alignment/hhrlhf_rw.yaml"),
                             f"model.path={SMOKE / 'tiny_model'}", "model.init_from_scratch=true",
                             "model.dtype=float32", "model.param_dtype=float32", "model.bucket_step=64",
                             "train_dataset.type=synthetic_pref", "train_dataset.batch_size=4",
                             "total_train_steps=2", *_files_under(tmp_path)], device="cpu")
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)


def test_eval_twin(tmp_path, monkeypatch, nothing_left):
    """``gsm8k_eval.main`` and the JAX script greedy-decode the same 32 rows
    from one HF export of the tiny model, each through its own in-process
    server, in f32: the same n and accuracy."""
    monkeypatch.delenv("AREAL_TPU_SERVER_ADDRS", raising=False)
    mcfg = dataclasses.replace(qwen.ModelConfig.from_hf_path(str(SMOKE / "tiny_model")), dtype="float32")
    export = tmp_path / "export"
    save_params_to_hf(qwen.init_params(mcfg, torch.Generator().manual_seed(3), device="cpu"), mcfg, str(export))
    for reg in (jd._REGISTRY, td._REGISTRY):
        monkeypatch.setitem(reg, "synthetic_arith", functools.partial(reg["synthetic_arith"], n=32))
    argv = ["--config", str(SMOKE / "synthetic_grpo.yaml"), f"server.model_path={export}", "actor.path=",
            "server.dtype=float32", "server.seed=0", "gconfig.max_new_tokens=6"]
    jax_eval = _load_jax_example("gsm8k_eval", monkeypatch)
    want = jax_eval.main(argv)
    got = gsm8k_eval.main(argv, device="cpu")
    assert got["n"] == want["n"] == 32 and got["failed"] == want["failed"] == 0
    assert got["accuracy"] == want["accuracy"] and got["mean_reward"] == want["mean_reward"]
