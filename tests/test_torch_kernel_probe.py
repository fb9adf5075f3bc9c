"""The decode-loop probe and the analytic hardware accounting: the port
(``observability/kernel_probe.py``, ``observability/hw_accounting.py``)
against the JAX package.

``DecodeStepTimeline`` runs on a shared fake clock, so its breakdowns agree
exactly; the analytic costs agree to 1e-12 relative at Qwen2.5-1.5B's full
dims (analytic, so cheap here) and at the tiny test model. Mirrors
``test_kernel_probe.py`` and ``test_step_timeline.py``'s ledger tests.
"""

import numpy as np
import pytest
import torch

from areal_tpu.models import qwen as jq
from areal_tpu.observability import hw_accounting as jhw
from areal_tpu.observability import kernel_probe as jkp
from areal_tpu_torch.observability import hw_accounting as thw
from areal_tpu_torch.observability import kernel_probe as tkp
from areal_tpu_torch.observability import step_timeline as tst

from test_torch_qwen import port_cfg
from tpu_testing import TINY_QWEN2

REL = 1e-12
# Qwen2.5-1.5B (huggingface.co/Qwen/Qwen2.5-1.5B config.json)
QWEN25_15B = jq.ModelConfig(
    vocab_size=151936, hidden_size=1536, intermediate_size=8960, num_layers=28, num_heads=12, num_kv_heads=2,
    head_dim=128, rope_theta=1_000_000.0, tie_word_embeddings=True, attention_bias=True, dtype="bfloat16",
)
QWEN3_MOE_TINY = jq.ModelConfig(
    vocab_size=256, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
    num_experts=8, num_experts_per_tok=2, moe_intermediate_size=16, tie_word_embeddings=False, dtype="float32",
)
MODELS = {"qwen2.5-1.5b": QWEN25_15B, "tiny": TINY_QWEN2, "tiny-moe": QWEN3_MOE_TINY}


class FakeClock:
    def __init__(self):
        self.t = 10.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(jkp.time, "monotonic", c)
    assert tkp.time is jkp.time
    return c


def _close(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=REL, abs=0.0), k


@pytest.mark.parametrize("name", sorted(MODELS))
def test_analytic_costs_match_jax(name):
    jcfg = MODELS[name]
    tcfg = port_cfg(jcfg)
    assert thw.transformer_param_counts(tcfg) == jhw.transformer_param_counts(jcfg)
    for steps, slots, ctx in ((16, 32, 1024.0), (1, 1, 7.5), (4, 8, 16384.0)):
        _close(thw.decode_step_costs(tcfg, steps, slots, ctx), jhw.decode_step_costs(jcfg, steps, slots, ctx))
        _close(thw.decode_step_costs(tcfg, steps, slots, ctx, kv_bytes_per_elem=1),
               jhw.decode_step_costs(jcfg, steps, slots, ctx, kv_bytes_per_elem=1))
    for n in (1, 256, 8192):
        _close(thw.prefill_costs(tcfg, n), jhw.prefill_costs(jcfg, n))
    for ctx in (512.0, 4096.0):
        _close(thw.decode_device_attribution(tcfg, ctx), jhw.decode_device_attribution(jcfg, ctx))
    for extra, remat in ((0, False), (2, True)):
        assert thw.train_step_flops(tcfg, 4096, extra, remat) == pytest.approx(
            jhw.train_step_flops(jcfg, 4096, extra, remat), rel=REL
        )
    # the trainer's MFU input keeps its count
    assert tst.matmul_params(tcfg) == jhw.transformer_param_counts(jcfg)["matmul"]
    for donate in (True, False):
        assert thw.step_transient_bytes(10, 7, donate) == jhw.step_transient_bytes(10, 7, donate)


def test_qwen25_15b_counts():
    """Qwen2.5-1.5B: 1.54 B parameters (1.31 B without the tied table)."""
    pc = thw.transformer_param_counts(port_cfg(QWEN25_15B))
    assert pc["total"] == 1_543_714_304 - 28 * (1536 + 2 * 256)  # the q/k/v biases are not counted
    assert pc["embedding"] == 151936 * 1536


def test_peak_table_keys_on_the_card_name(monkeypatch):
    assert thw.chip_peak_flops("cpu") is None and thw.chip_peak_membw("cpu") is None
    assert thw.chip_hbm_bytes("cpu") is None
    assert thw.chip_peak_flops("cpu", override_tflops=100) == 100e12
    assert thw.chip_peak_membw("cpu", override_gbps=2000) == 2000e9
    assert thw.is_cpu("cpu") and not thw.is_cpu("cuda:0")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert thw.chip_peak_flops("cuda:0") == 989e12
    assert thw.chip_peak_membw("cuda:0") == 3.35e12
    assert thw.chip_hbm_bytes("cuda:0") == 80e9
    # another card (a PCIe H100 has other peaks) is not guessed
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 PCIe")
    assert thw.chip_peak_flops("cuda:0") is None and thw.chip_peak_membw("cuda:0") is None
    # the port's table holds no TPU row
    assert all("v" not in key.split()[0] for key, *_ in thw.CHIP_SPECS)


def test_tree_bytes_and_cpu_ledger_match_jax():
    arrays = {"a": np.zeros((3, 5), np.float32), "b": [np.zeros(7, np.int8), np.float32(1.0)]}
    tensors = {"a": torch.zeros((3, 5)), "b": [torch.zeros(7, dtype=torch.int8), np.float32(1.0)]}
    assert thw.tree_bytes(tensors) == thw.tree_bytes(arrays) == jhw.tree_bytes(arrays) == 60 + 7 + 4
    assert thw.tree_bytes(None) == jhw.tree_bytes(None) == 0
    comps = {"params": 1000, "kv_page_pool": 500, "radix_cache": 200, "staged_update": 0}
    for override in (None, 0.000002):
        t = thw.build_hbm_ledger(comps, device="cpu", override_hbm_gb=override, exclude_from_total=("radix_cache",))
        j = jhw.build_hbm_ledger(comps, override_hbm_gb=override, exclude_from_total=("radix_cache",))
        assert {k: t[k] for k in j} == j
        assert t["source"] == "analytic" and t["peak_bytes"] is None
    assert thw.device_memory_stats("cpu") is None


def test_calibrate_host_peaks_once():
    f, b = thw.calibrate_host_peaks()
    assert f > 0 and b > 0
    assert thw.calibrate_host_peaks() == (f, b)


def _script(tl, clock, script):
    """Drive phase spans on ``tl``: ("enter", name) / ("exit",) / dt."""
    stack = []
    for op in script:
        if isinstance(op, float):
            clock.t += op
        elif op[0] == "enter":
            cm = tl.phase(op[1])
            cm.__enter__()
            stack.append(cm)
        else:
            stack.pop().__exit__(None, None, None)


STEP = [("enter", "admission"), 0.001, ("enter", "radix_match"), 0.0005, ("exit",), 0.0002,
        ("enter", "prefill"), 0.03, ("exit",), ("exit",), 0.0001, ("enter", "dispatch"), 0.4, ("exit",),
        ("enter", "device_wait"), 0.02, ("exit",), ("enter", "bookkeeping"), 0.003, ("exit",), 0.0007]


def test_step_timeline_identity_and_nesting_match_jax(clock):
    bds = []
    for mod in (jkp, tkp):
        clock.t = 10.0
        tl = mod.DecodeStepTimeline()
        _script(tl, clock, STEP)
        bds.append(tl.breakdown())
    assert bds[1] == bds[0]
    bd = bds[1]
    assert tkp.DECODE_PHASES == jkp.DECODE_PHASES
    # exclusive nesting: the inner phases own their spans
    assert bd["admission_s"] == pytest.approx(0.0012) and bd["radix_match_s"] == pytest.approx(0.0005)
    assert bd["prefill_s"] == pytest.approx(0.03)
    named = sum(bd[f"{p}_s"] for p in tkp.DECODE_PHASES)
    assert named + bd["other_s"] == bd["total_s"]
    assert bd["other_s"] == pytest.approx(0.0008)


@pytest.mark.parametrize(
    "args",
    [(1e12, 1e9, 0.01, 989e12, 3.35e12), (1e12, 0.0, 0.01, 989e12, None), (0.0, 1e9, 0.01, 1e12, 1e12),
     (5e9, 5e9, 1e-6, 1e12, 1e9), (1e12, 1e9, 0.0, 1e12, 1e9), (1e12, 1e9, 0.5, None, 1e9)],
)
def test_roofline_fraction_matches_jax(args):
    for chips in (1, 4):
        assert tkp.roofline_fraction(*args, n_chips=chips) == jkp.roofline_fraction(*args, n_chips=chips)


def test_probe_stats_match_jax(clock):
    out = []
    for mod, cfg in ((jkp, TINY_QWEN2), (tkp, port_cfg(TINY_QWEN2))):
        clock.t = 10.0
        probe = mod.KernelProbe(model_cfg=cfg, peak_flops=1e12, peak_membw=1e11)
        probe.record_cost(("chunk", 4, 8, 2), 2e9, 1e8, "analytic")
        for i in range(3):
            tl = probe.begin_step()
            _script(tl, clock, STEP)
            probe.complete_step(tl, tokens=32, cost_key=("chunk", 4, 8, 2) if i else None)
        probe.abandon_step(probe.begin_step())
        out.append((probe.stats(), probe.recent()))
    (js, jr), (ts, tr) = out
    assert ts == js and tr == jr
    assert ts["steps"] == 3 and ts["abandoned"] == 1 and ts["dominant_phase"] == "dispatch"
    assert ts["costs"] == {"chunk|4|8|2": {"flops": 2e9, "bytes": 1e8, "source": "analytic"}}
    for rec in tr:
        bd = rec["breakdown"]
        assert sum(bd[f"{p}_s"] for p in tkp.DECODE_PHASES) + bd["other_s"] == bd["total_s"]


def test_probe_peaks_by_device():
    cpu = tkp.KernelProbe(device="cpu")
    assert cpu.peak_source == "calibrated" and cpu.peak_flops > 0
    assert tkp.KernelProbe(device="cpu", calibrate=False).peak_source == "unknown"
