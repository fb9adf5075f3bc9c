"""The port's server command line (``python -m areal_tpu_torch.inference.server``)
on the CPU: a subprocess serving a tiny HF export from a ``ServerConfig``
YAML plus overrides answers ``/health`` and ``/generate``; under SIGTERM
with ``preemption.enabled`` it drains and exits with ``exit_code``,
leaving its flight dump; ``--name`` waits for server discovery."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from areal_tpu_torch.inference import server as server_mod
from areal_tpu_torch.models import qwen
from areal_tpu_torch.models.hf import save_params_to_hf
from areal_tpu_torch.utils.network import find_free_port

ROOT = Path(__file__).resolve().parent.parent
EXIT_CODE = 7


def _wait_healthy(addr: str, proc, timeout: float = 120.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"server exited with {proc.returncode}")
        try:
            with urllib.request.urlopen(f"http://{addr}/health", timeout=2) as r:
                return json.loads(r.read())
        except (urllib.error.URLError, ConnectionError, OSError):
            time.sleep(0.2)
    raise AssertionError("server not healthy")


def test_cli_serves_and_drains_on_sigterm(tmp_path):
    mcfg = dataclasses.replace(qwen.ModelConfig.from_hf_path(str(ROOT / "examples/smoke/tiny_model")),
                               dtype="float32")
    export = tmp_path / "export"
    save_params_to_hf(qwen.init_params(mcfg, torch.Generator().manual_seed(0), device="cpu"), mcfg, str(export))
    port = find_free_port()
    cfg = tmp_path / "server.yaml"
    cfg.write_text(
        "dtype: float32\nmax_batch_size: 4\nmax_seq_len: 64\npage_size: 16\ndecode_steps_per_call: 4\n"
        "host: 127.0.0.1\nseed: 0\nprecompile: true\n"
        f"preemption:\n  enabled: true\n  grace_s: 20.0\n  drain_budget_s: 2.0\n  exit_code: {EXIT_CODE}\n"
    )
    flight = tmp_path / "flight"
    env = {**os.environ, "AREAL_FLIGHT_DIR": str(flight), "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "areal_tpu_torch.inference.server", "--device", "cpu", "--config", str(cfg),
         f"model_path={export}", f"port={port}"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        addr = f"127.0.0.1:{port}"
        assert _wait_healthy(addr, proc)["status"] == "ok"
        body = json.dumps({"input_ids": [5, 6, 7, 8], "sampling_params": {"max_new_tokens": 5, "greedy": True}})
        req = urllib.request.Request(f"http://{addr}/generate", data=body.encode(),
                                     headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert len(out["output_tokens"]) == 5 and out["stop_reason"] == "length"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=20) == EXIT_CODE
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log = proc.stdout.read()
    dumps = sorted(flight.glob("flight_inference_server_*_preempt.json"))
    assert dumps, log[-2000:]
    events = json.loads(dumps[0].read_text())
    assert events["dump_reason"] == "preempt" and "preempt_signal" in {e["kind"] for e in events["events"]}
    assert "preemption drain complete" in log


def test_cli_name_waits_for_discovery():
    with pytest.raises(NotImplementedError, match="item 8"):
        server_mod.main(["--name", "x", "--device", "cpu"])


def test_precompile_on_the_cpu_builds_nothing():
    """``precompile`` builds the kernels a card engine can launch; the CPU
    engine runs their plain versions, so there is nothing to build."""
    from areal_tpu_torch.api.config import ServerConfig
    from areal_tpu_torch.inference.decode_engine import DecodeEngine

    mcfg = qwen.ModelConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=1, num_heads=2,
                            num_kv_heads=1, dtype="float32")
    scfg = ServerConfig(max_batch_size=2, max_seq_len=32, page_size=16, precompile=True)
    eng = DecodeEngine(scfg, params=qwen.init_params(mcfg, torch.Generator().manual_seed(0), device="cpu"),
                       device="cpu")
    eng.initialize()
    assert eng.precompile() == []


@pytest.mark.parametrize("heads,ok", [((12, 2, 128, 128), True), ((32, 4, 128, 128), True), ((4, 2, 16, 16), False),
                                      ((18, 2, 128, 128), False), ((12, 2, 64, 6), False)],
                         ids=["qwen2.5-1.5b", "qwen3-30b-a3b", "tiny-head_dim-16", "group-9", "page-6"])
def test_decode_kernel_head_check(heads, ok):
    """What the card engine refuses at its start: the decode kernel's own
    check (head_dim 64 / 128, H / KH <= 8, page size a multiple of 4)."""
    from areal_tpu_torch.ops.paged_attention import check_heads

    if ok:
        check_heads(*heads)
    else:
        with pytest.raises(ValueError):
            check_heads(*heads)
