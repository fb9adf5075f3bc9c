"""Rules the PyTorch port keeps: it imports nothing of JAX or of the JAX
package (not even its JAX-free modules), nor aiohttp or yaml (the GPU hosts
it runs on install neither), and it never falls back to the CPU by itself."""

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
FORBIDDEN_ROOTS = {"jax", "jaxlib", "areal_tpu", "aiohttp", "yaml"}


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
    cases = [
        ("import jax.numpy as jnp\nfrom areal_tpu.api import config\nimport areal_tpu_torch\n",
         ["jax", "areal_tpu", "areal_tpu_torch"]),
        ("import aiohttp\nfrom aiohttp import web\n", ["aiohttp", "aiohttp"]),
        ("import yaml\nx = __import__('yaml')\n", ["yaml", "yaml"]),
    ]
    for i, (source, roots) in enumerate(cases):
        f = tmp_path / f"x{i}.py"
        f.write_text(source)
        found = [m.split(".")[0] for m in _imported_modules(f)]
        assert found == roots
        assert [r for r in found if r in FORBIDDEN_ROOTS] == [r for r in roots if r != "areal_tpu_torch"]


def test_no_silent_cpu_fallback():
    """Without a card and without device="cpu", every entry point raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU refusal cannot be observed")
    cfg = ServerConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        DecodeEngine(cfg)
    with pytest.raises(RuntimeError):
        InferenceServer(cfg)
    with pytest.raises(RuntimeError):
        qwen.QwenModel(qwen.ModelConfig(num_layers=1))
    # the trainer loop: PPOTrainer builds its train engine on the card, and
    # refuses before it reaches the rollout client
    from areal_tpu_torch.api.config import PPOConfig, PreemptionConfig
    from areal_tpu_torch.trainer.rl_trainer import PPOTrainer

    class _Rollout:
        calls = 0

        def __getattr__(self, name):
            _Rollout.calls += 1
            raise AssertionError(f"the rollout engine was used ({name})")

    with pytest.raises(RuntimeError, match="device='cpu'"):
        PPOTrainer(PPOConfig(weight_update_mode="mem", preemption=PreemptionConfig(enabled=False)),
                   [{"prompt_ids": [1]}], rollout=_Rollout())
    assert _Rollout.calls == 0
    # the weight update over HTTP streams what it is given and never moves
    # the trainer's tensors: a CUDA tensor without a card cannot even exist,
    # and a train engine without device="cpu" raises (above)
    from areal_tpu_torch.api.config import InferenceEngineConfig
    from areal_tpu_torch.api.io_struct import WeightUpdateMeta
    from areal_tpu_torch.inference.client import RemoteTorchEngine

    c = RemoteTorchEngine(InferenceEngineConfig(), addresses=["127.0.0.1:1"])
    with pytest.raises(ValueError, match="needs params"):
        c.update_weights(WeightUpdateMeta())
    c.destroy()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize(
    "change",
    [
        dict(quantization="int8"),
        dict(enable_frequency_penalty=True),
        dict(mesh=MeshConfig(model=2)),
    ],
    ids=["int8_weights", "freq_penalty", "mesh"],
)
def test_unported_options_refused(change):
    cfg = dataclasses.replace(ServerConfig(), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecodeEngine(cfg, device="cpu")


@pytest.mark.parametrize(
    "change",
    [{}, dict(speculative=SpeculativeConfig(enabled=True))],
    ids=["defaults", "speculative"],
)
def test_default_server_config_serves(change):
    """``ServerConfig()`` as it comes (radix prefix cache on, 32 slots of
    32,768 tokens), and with speculative decoding on, initializes and answers
    a request (a one-layer model keeps the default page pool small)."""
    from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest

    cfg = dataclasses.replace(ServerConfig(), **change)
    assert cfg.enable_prefix_caching and cfg.prefix_cache.enabled
    mcfg = qwen.ModelConfig(vocab_size=64, hidden_size=16, intermediate_size=32, num_layers=1,
                            num_heads=2, num_kv_heads=1, dtype="float32")
    model = qwen.init_params(mcfg, torch.Generator().manual_seed(0), device="cpu")
    eng = DecodeEngine(cfg, params=model, device="cpu")
    eng.start()
    try:
        resp = eng.generate_sync(
            ModelRequest(input_ids=[1, 2, 3, 1, 2, 3], gconfig=GenerationHyperparameters(max_new_tokens=5, greedy=True)),
            timeout=120,
        )
    finally:
        eng.stop()
    assert resp.stop_reason == "length" and len(resp.output_tokens) == 5
    assert eng.prefix_cache_stats()["enabled"] and eng.prefix_cache_stats()["pages_held"] == 0
    assert (eng.stats["spec_rounds"] > 0) == bool(change)


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


def test_tree_kernel_wrappers_refuse_other_devices():
    """A tree-attention wrapper takes a CPU tensor (the plain version) or a
    CUDA one (the kernel), and raises on any other device."""
    from areal_tpu_torch.ops import tree_attention as ta

    q = torch.zeros((128, 2, 64), device="meta")
    w = torch.zeros((128, 4), dtype=torch.int32, device="meta")
    b = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    row = torch.zeros((128, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ta.tree_attention_fwd(q, q, q, w, b, with_lse=True)
    with pytest.raises(ValueError, match="unsupported device"):
        ta.tree_attention_bwd_dq(q, q, q, w, b, q, row, row)
    with pytest.raises(ValueError, match="unsupported device"):
        ta.tree_attention_bwd_dkv(q, q, q, w, b, q, row, row)


@pytest.mark.parametrize(
    "change",
    [
        dict(tree_training=True, value_head=True),
        dict(lora_rank=8),
        dict(train_vision_tower=True),
        dict(mesh=MeshConfig(fsdp=2)),
        dict(weight_update_mode="disk"),
        dict(attn_impl="ring"),
        dict(value_head=True),
        dict(remat_policy="dots_nobatch"),
    ],
    ids=["tree-critic", "lora", "vision", "mesh", "disk-update", "ring", "critic", "remat-dots"],
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


def test_moe_training_refused():
    """MoE training is a ported path now (the grouped matmul has its backward
    kernels): the engine takes an MoE model, and what it still refuses for
    one is what it refuses for every model, here an expert-parallel mesh."""
    from areal_tpu_torch.api.config import MeshConfig, PPOActorConfig
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine

    mcfg = qwen.ModelConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=1, num_heads=2,
                            num_kv_heads=1, num_experts=4, moe_intermediate_size=16)
    eng = TorchTrainEngine(PPOActorConfig(), model_config=mcfg, device="cpu")
    eng.initialize()
    assert eng.model.layers[0].we_gate.requires_grad
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchTrainEngine(PPOActorConfig(mesh=MeshConfig(expert=2)), model_config=mcfg, device="cpu")


def test_gmm_wrapper_refuses_other_devices():
    """The grouped-matmul wrapper takes a CPU tensor (the plain version) or a
    CUDA one (the kernel), and raises on any other device."""
    from areal_tpu_torch.ops.gmm import gmm

    lhs = torch.zeros((16, 32), device="meta")
    rhs = torch.zeros((4, 32, 64), device="meta")
    sizes = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gmm(lhs, rhs, sizes)


def test_chip_smoke_drives_moe_serving():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert {"kernel_gmm", "serve_moe"} <= set(chip_smoke.PHASES)
