"""Rules the PyTorch port keeps: it imports nothing of JAX or of the JAX
package (not even its JAX-free modules), nor aiohttp, yaml, safetensors or
orbax (the GPU hosts it runs on install none of them: the port reads and
writes safetensors with its own code), and it never falls back to the CPU
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
FORBIDDEN_ROOTS = {"jax", "jaxlib", "areal_tpu", "aiohttp", "yaml", "safetensors", "orbax"}


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


def test_multi_gpu_modules_covered():
    """The trainer across GPUs keeps its own copies of the JAX package's
    JAX-free modules; the import rule above covers them."""
    rel = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"areal_tpu_torch/parallel/__init__.py", "areal_tpu_torch/parallel/mesh.py",
            "areal_tpu_torch/parallel/tensor_parallel.py", "areal_tpu_torch/api/alloc_mode.py",
            "areal_tpu_torch/utils/network.py", "areal_tpu_torch/infra/dist_rollout.py"} <= rel


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
        ("try:\n    from safetensors.torch import save_file\nexcept ImportError:\n    pass\n"
         "import orbax.checkpoint as ocp\n", ["orbax", "safetensors"]),  # ast.walk goes breadth first
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
    "change, refused",
    [
        (dict(quantization="int8"), False),  # ported with Queue A item 4
        (dict(mesh=MeshConfig(seq=2)), True),  # model=N serves (item 6b-1); seq is 6b-3
    ],
    ids=["int8_weights", "mesh"],
)
def test_unported_options_refused(change, refused):
    """The serving options of later slices raise naming their ROADMAP item;
    int8 weights (item 4) construct; a ``model`` mesh constructs (item 6b-1)
    and a ``seq`` one raises."""
    cfg = dataclasses.replace(ServerConfig(), **change)
    if refused:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DecodeEngine(cfg, device="cpu")
    else:
        assert DecodeEngine(cfg, device="cpu")._quantized


@pytest.mark.parametrize(
    "change",
    [{}, dict(speculative=SpeculativeConfig(enabled=True)), dict(enable_frequency_penalty=True)],
    ids=["defaults", "speculative", "freq_penalty"],
)
def test_default_server_config_serves(change):
    """``ServerConfig()`` as it comes (radix prefix cache on, 32 slots of
    32,768 tokens), with speculative decoding on, and with the frequency
    penalty's count table, initializes and answers a request (a one-layer
    model keeps the default page pool small); the penalized request under
    the penalty differs from the unpenalized one."""
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
        penalized = eng.generate_sync(
            ModelRequest(input_ids=[1, 2, 3, 1, 2, 3], gconfig=GenerationHyperparameters(
                max_new_tokens=5, greedy=True, frequency_penalty=50.0)),
            timeout=120,
        )
    finally:
        eng.stop()
    assert resp.stop_reason == "length" and len(resp.output_tokens) == 5
    # a penalty of 50 forbids any repeat on this model's logits, where the
    # unpenalized greedy output repeats; without the table the penalty is
    # ignored (warned)
    if change.get("enable_frequency_penalty"):
        assert len(set(resp.output_tokens)) < 5 and len(set(penalized.output_tokens)) == 5
    else:
        assert penalized.output_tokens == resp.output_tokens
    assert eng.prefix_cache_stats()["enabled"] and eng.prefix_cache_stats()["pages_held"] == 0
    assert (eng.stats["spec_rounds"] > 0) == ("speculative" in change)


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
        dict(lora_rank=8),
        dict(train_vision_tower=True),
        dict(mesh=MeshConfig(seq=2)),
        dict(attn_impl="ring"),
    ],
    ids=["lora", "vision", "mesh", "ring"],
)
def test_unported_trainer_options_refused(change):
    """The trainer options of later slices raise naming their ROADMAP item;
    LoRA (item 4) constructs and trains only its adapters; a trainable
    vision tower (item 5) constructs, and on a model without a tower raises
    at ``initialize`` as JAX's engine does."""
    from areal_tpu_torch.api.config import PPOActorConfig
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine

    cfg = dataclasses.replace(PPOActorConfig(), **change)
    mcfg = qwen.ModelConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=1, num_heads=2,
                            num_kv_heads=1)
    if "lora_rank" in change:
        eng = TorchTrainEngine(cfg, model_config=mcfg, device="cpu")
        eng.initialize()
        assert eng._train_names and all("_lora_" in n for n in eng._train_names)
        return
    if "train_vision_tower" in change:
        eng = TorchTrainEngine(cfg, model_config=mcfg, device="cpu")
        with pytest.raises(ValueError, match="no vision tower"):
            eng.initialize()
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchTrainEngine(cfg, model_config=mcfg, device="cpu")


def test_tree_training_with_a_value_head_refused():
    """The JAX engine asserts that tree training is a policy-only path; the
    port raises ``ValueError`` for it (JAX semantics, not a later slice)."""
    from areal_tpu_torch.api.config import PPOActorConfig
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine

    cfg = dataclasses.replace(PPOActorConfig(), tree_training=True)
    with pytest.raises(ValueError, match="policy-only"):
        TorchTrainEngine(cfg, value_head=True, model_config=qwen.ModelConfig(
            vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=1, num_heads=2, num_kv_heads=1,
        ), device="cpu")


@pytest.mark.parametrize(
    "change", [dict(weight_update_mode="disk"), dict(path="unused/hf")], ids=["disk-update", "hf-path"]
)
def test_ported_trainer_options_accepted(change):
    """Disk weight updates and an HF checkpoint path construct (the
    checkpoint is read at ``initialize``: ``tests/test_torch_checkpoint.py``);
    an unknown update mode is refused."""
    from areal_tpu_torch.api.config import PPOActorConfig
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine

    cfg = dataclasses.replace(PPOActorConfig(), **change)
    TorchTrainEngine(cfg, model_config=qwen.ModelConfig(num_layers=1), device="cpu")
    with pytest.raises(ValueError, match="disk|mem"):
        TorchTrainEngine(dataclasses.replace(cfg, weight_update_mode="nccl"), device="cpu")


def test_moe_training_refused():
    """MoE training is a ported path now (the grouped matmul has its backward
    kernels), on an ``expert`` mesh too: the engine takes an MoE model, and
    what it still refuses for one is what it refuses for every model, here a
    sequence-parallel mesh."""
    from areal_tpu_torch.api.config import MeshConfig, PPOActorConfig
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine

    mcfg = qwen.ModelConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=1, num_heads=2,
                            num_kv_heads=1, num_experts=4, moe_intermediate_size=16)
    eng = TorchTrainEngine(PPOActorConfig(), model_config=mcfg, device="cpu")
    eng.initialize()
    assert eng.model.layers[0].we_gate.requires_grad
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchTrainEngine(PPOActorConfig(mesh=MeshConfig(seq=2)), model_config=mcfg, device="cpu")
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
    assert {"kernel_gmm", "serve_moe", "observe"} <= set(chip_smoke.PHASES)


# -- the decode loop's hot path: no device sync from the observability ------

SYNC_CALLS = {"item", "cpu", "tolist", "numpy", "synchronize"}
OBS = ROOT / "areal_tpu_torch" / "observability"
ENGINE = ROOT / "areal_tpu_torch" / "inference" / "decode_engine.py"
# the engine's observability methods: no device read anywhere in them
ENGINE_OBS_METHODS = {"_kphase", "_abandon_kstep", "_close_kstep", "kernel_stats", "_register_cost", "hbm_ledger",
                      "is_wedged"}
# calls on a timeline / the flight ring / the probe (the mark sites)
MARK_CALLS = {"mark", "record", "dump", "start", "complete", "begin_step", "complete_step", "abandon_step"}
MARK_RECEIVERS = ("timeline", "flight", "kprobe")
TIMELINE_FIELDS = {"fence_stall_s", "fence_stall_pre_first_s", "park_s", "version"}


def _sync_calls(node) -> list[tuple[str, int]]:
    return [
        (n.func.attr, n.lineno)
        for n in ast.walk(node)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and n.func.attr in SYNC_CALLS
    ]


def _engine_hot_path_faults(source: str) -> list[str]:
    """Device reads at the engine's observability sites: in its
    observability methods, in the arguments of a mark site, in a value
    stored on a timeline; and a ``synchronize`` inside a probe phase other
    than ``device_wait``."""
    tree = ast.parse(source)
    faults = []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in ENGINE_OBS_METHODS:
            faults += [f"{node.name}: .{a}() line {ln}" for a, ln in _sync_calls(node)]
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in MARK_CALLS
            and any(r in ast.unparse(node.func.value) for r in MARK_RECEIVERS)
        ):
            faults += [f"mark site line {node.lineno}: .{a}()" for a, _ in _sync_calls(node)]
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if any(isinstance(t, ast.Attribute) and t.attr in TIMELINE_FIELDS and "timeline" in ast.unparse(t.value)
                   for t in targets):
                faults += [f"timeline field line {node.lineno}: .{a}()" for a, _ in _sync_calls(node.value)]
        elif isinstance(node, ast.With):
            for item in node.items:
                call = item.context_expr
                if not (isinstance(call, ast.Call) and getattr(call.func, "attr", "") == "_kphase"):
                    continue
                phase = call.args[0].value if call.args and isinstance(call.args[0], ast.Constant) else "?"
                if phase != "device_wait":
                    faults += [f"phase {phase} line {ln}: .synchronize()" for a, ln in _sync_calls(node)
                               if a == "synchronize"]
    return faults


@pytest.mark.parametrize("name", ["timeline.py", "kernel_probe.py"])
def test_hot_observability_modules_never_read_the_device(name):
    bad = _sync_calls(ast.parse((OBS / name).read_text()))
    assert not bad, f"{name} calls {bad}"


def test_hw_accounting_reads_the_device_only_to_calibrate():
    tree = ast.parse((OBS / "hw_accounting.py").read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert _sync_calls(fns["calibrate_host_peaks"])  # the init-time measurement
    bad = {name: _sync_calls(fn) for name, fn in fns.items() if name != "calibrate_host_peaks" and _sync_calls(fn)}
    assert not bad


def test_engine_mark_sites_never_read_the_device():
    source = ENGINE.read_text()
    assert not _engine_hot_path_faults(source)
    # the one allowed wait: _drain's device_wait phase holds the sync
    tree = ast.parse(source)
    drain = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "_drain")
    waits = [w for w in ast.walk(drain) if isinstance(w, ast.With)
             and "_kphase('device_wait')" in ast.unparse(w.items[0].context_expr)]
    assert len(waits) == 1 and [a for a, _ in _sync_calls(waits[0])].count("synchronize") == 1


@pytest.mark.parametrize(
    "snippet",
    [
        "def f(self, t):\n    t.timeline.mark('x', n=int(self.x.item()))\n",
        "def f(self):\n    self.flight.record('evt', n=self.t.tolist())\n",
        "def f(self, task):\n    task.timeline.fence_stall_s += self.dt.cpu()\n",
        "def f(self):\n    with self._kphase('bookkeeping'):\n        self.ev.synchronize()\n",
        "def kernel_stats(self):\n    return self.x.numpy()\n",
    ],
)
def test_hot_path_rule_catches_a_device_read(snippet):
    assert _engine_hot_path_faults(snippet)
    assert not _engine_hot_path_faults("def f(self):\n    with self._kphase('device_wait'):\n        e.synchronize()\n")
