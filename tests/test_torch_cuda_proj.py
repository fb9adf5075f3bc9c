"""The projection's int8 and adapter branches (``models/qwen.py _proj``) and
the int8 transform on a card against the same functions on the CPU, at
Qwen2.5-1.5B's projection shapes. Marked ``cuda``: skipped where there is
no GPU, and free of JAX so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_proj.py
"""

from types import SimpleNamespace

import pytest
import torch

from areal_tpu_torch.models import qwen

# bf16 products summed in other orders and tilings on the two devices: a
# few bf16 steps of the output's scale
REL = 2e-2
SHAPES = {"wq": (1536, 1536), "wk": (256, 1536), "w_gate": (8960, 1536), "w_down": (1536, 8960)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _layer(name: str, seed: int, rank: int = 0):
    g = torch.Generator().manual_seed(seed)
    out_f, in_f = SHAPES[name]
    w = 0.02 * torch.randn((out_f, in_f), generator=g)
    q8, s = qwen.quantize_dense_int8(w)
    layer = {name: w.to(torch.bfloat16), f"{name}_q8": q8, f"{name}_scale": s}
    if rank:
        layer[f"{name}_lora_a"] = (0.02 * torch.randn((rank, in_f), generator=g)).to(torch.bfloat16)
        layer[f"{name}_lora_b"] = (0.02 * torch.randn((out_f, rank), generator=g)).to(torch.bfloat16)
    x = torch.randn((64, in_f), generator=g).to(torch.bfloat16)
    return layer, x


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float().cpu() - want.float()).abs().max().item()
    assert err <= REL * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_int8_transform_same_bits_on_card(cuda, name):
    """``quantize_dense_int8`` gives the CPU's bits on the card (the scale's
    division is a true f32 division on both)."""
    layer, _ = _layer(name, seed=1)
    q8, s = qwen.quantize_dense_int8(layer[name].float().to(cuda))
    w = layer[name].float()
    q8_cpu, s_cpu = qwen.quantize_dense_int8(w)
    assert torch.equal(q8.cpu(), q8_cpu) and torch.equal(s.cpu(), s_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["int8", "lora", "int8_lora"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_proj_branches_on_card(cuda, name, branch):
    """``_proj`` with an int8 weight, with adapters (rank 32, alpha 16), and
    with both, on the card against the CPU on the same inputs."""
    rank = 32 if "lora" in branch else 0
    layer, x = _layer(name, seed=2, rank=rank)
    if "int8" in branch:
        layer.pop(name)
    else:
        layer.pop(f"{name}_q8")
        layer.pop(f"{name}_scale")
    cfg = qwen.ModelConfig(lora_rank=rank, lora_alpha=16.0, lora_targets=(name,))
    want = qwen._proj(cfg, SimpleNamespace(**layer), name, x)
    got = qwen._proj(cfg, SimpleNamespace(**{k: v.to(cuda) for k, v in layer.items()}), name, x.to(cuda))
    _close(got, want)
