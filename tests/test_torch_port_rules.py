"""Rules the PyTorch port keeps: it imports nothing of JAX or of the JAX
package (not even its JAX-free modules), and it never falls back to the CPU
by itself."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from areal_tpu_torch import resolve_device
from areal_tpu_torch.api.config import MeshConfig, ServerConfig, SpeculativeConfig
from areal_tpu_torch.inference.decode_engine import DecodeEngine
from areal_tpu_torch.inference.server import InferenceServer
from areal_tpu_torch.models import qwen

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "areal_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN_ROOTS = {"jax", "jaxlib", "areal_tpu"}


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.append(node.module)
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", "")) in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            mods.append(str(node.args[0].value))
    return mods


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "decode_engine.py", "paged_attention.py", "qwen.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_areal_tpu_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN_ROOTS]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_rule_catches_forbidden_imports(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import jax.numpy as jnp\nfrom areal_tpu.api import config\nimport areal_tpu_torch\n")
    assert [m.split(".")[0] for m in _imported_modules(f)] == ["jax", "areal_tpu", "areal_tpu_torch"]


def test_no_silent_cpu_fallback():
    """Without a card and without device="cpu", every entry point raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU refusal cannot be observed")
    cfg = ServerConfig(enable_prefix_caching=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        DecodeEngine(cfg)
    with pytest.raises(RuntimeError):
        InferenceServer(cfg)
    with pytest.raises(RuntimeError):
        qwen.QwenModel(qwen.ModelConfig(num_layers=1))
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize(
    "change",
    [
        dict(enable_prefix_caching=True),
        dict(speculative=SpeculativeConfig(enabled=True)),
        dict(quantization="int8"),
        dict(enable_frequency_penalty=True),
        dict(mesh=MeshConfig(model=2)),
    ],
    ids=["prefix_cache", "speculative", "int8_weights", "freq_penalty", "mesh"],
)
def test_unported_options_refused(change):
    cfg = dataclasses.replace(ServerConfig(enable_prefix_caching=False), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecodeEngine(cfg, device="cpu")


def test_trainer_refuses_without_card():
    """The train engine, like every entry point, raises with no card and no
    device="cpu"."""
    from areal_tpu_torch.api.config import PPOActorConfig
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU refusal cannot be observed")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchTrainEngine(PPOActorConfig(), model_config=qwen.ModelConfig(num_layers=1))
    TorchTrainEngine(PPOActorConfig(), model_config=qwen.ModelConfig(num_layers=1), device="cpu")


@pytest.mark.parametrize(
    "change",
    [
        dict(tree_training=True),
        dict(lora_rank=8),
        dict(train_vision_tower=True),
        dict(mesh=MeshConfig(fsdp=2)),
        dict(weight_update_mode="disk"),
        dict(attn_impl="ring"),
        dict(value_head=True),
        dict(remat_policy="dots_nobatch"),
    ],
    ids=["tree", "lora", "vision", "mesh", "disk-update", "ring", "critic", "remat-dots"],
)
def test_unported_trainer_options_refused(change):
    from areal_tpu_torch.api.config import PPOActorConfig
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine

    change = dict(change)
    value_head = change.pop("value_head", False)
    cfg = dataclasses.replace(PPOActorConfig(), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng = TorchTrainEngine(cfg, value_head=value_head, model_config=qwen.ModelConfig(
            vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=1, num_heads=2, num_kv_heads=1,
        ), device="cpu")
        # options read at the first forward (the remat policy)
        eng.initialize()
        eng.forward_batch({"input_ids": np.zeros((1, 4), np.int32), "attention_mask": np.ones((1, 4), bool)})
