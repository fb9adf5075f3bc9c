"""Allocation-mode DSL: one string ties the device topology to the
backends — the port of ``areal_tpu/api/alloc_mode.py`` (a copy: the port
imports nothing of the JAX package). The parser, the strategies and
``apply_allocation_mode`` behave as the JAX module's do. Accepted strings,
e.g.:

- ``d4t2p2``                      — pure parallel spec (train only)
- ``sglang:d4t2+fsdp:d8``         — disaggregated generation + training
- ``sglang[r]:d2+fsdp[a]:d4|fsdp[c]:d4``  — roles; ``|`` (colocation) binds
  tighter than ``+`` (disaggregation)
- ``vllm:d2t2+megatron:(attn:d4t2|ffn:d2e4)``  — MoE hybrid spec

Grammar::

    expr      := group ('+' group)*
    group     := alloc ('|' alloc)*
    alloc     := ident role? ':' pspec | pspec
    role      := '[' ident ']'
    pspec     := plain | '(' 'attn' ':' plain '|' 'ffn' ':' plain ')'
    plain     := (dim number)+      dim in {d,t,p,c,e} or 'et'

Every generation backend name resolves to the port's inference server and
every train backend name to ``TorchTrainEngine``; the parallel spec sizes
the mesh axes (dp -> fsdp, t -> model, c -> seq, e -> expert, p -> pipe;
``parallel/mesh.py``). Which sizes the port runs is the trainers' check
(``trainer/rl_trainer.py check_allocation``).
"""

from __future__ import annotations

import dataclasses
import re
from enum import Enum

GEN_BACKENDS = {"sglang", "vllm", "jax", "jax_server"}
TRAIN_BACKENDS = {"fsdp", "megatron", "archon", "gspmd", "jax_train"}

_DIM_ALIASES = {
    "d": "dp",
    "t": "tp",
    "p": "pp",
    "c": "cp",
    "e": "ep",
    "et": "etp",
}


class AllocationType(Enum):
    DECOUPLED = "decoupled"  # gen + train on disjoint devices
    COLOCATE = "colocate"  # gen | train sharing devices
    TRAIN_ONLY = "train_only"
    GEN_ONLY = "gen_only"


@dataclasses.dataclass(frozen=True)
class ParallelStrategy:
    """5-D parallel strategy; the mesh axis sizes it gives are
    ``_mesh_config_of``'s."""

    dp: int = 1
    tp: int = 1
    pp: int = 1
    cp: int = 1
    ep: int = 1
    etp: int = 1

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"parallel degree {f.name}={v!r} must be an int >= 1")

    @property
    def world_size(self) -> int:
        return self.dp * self.tp * self.pp * self.cp

    # Aliases matching reference naming
    @property
    def dp_size(self) -> int:
        return self.dp

    @property
    def tp_size(self) -> int:
        return self.tp

    @property
    def pp_size(self) -> int:
        return self.pp

    @property
    def cp_size(self) -> int:
        return self.cp

    @property
    def ep_size(self) -> int:
        return self.ep

    def __str__(self) -> str:
        parts = [f"d{self.dp}"]
        for letter, attr in (("t", "tp"), ("p", "pp"), ("c", "cp"), ("e", "ep")):
            v = getattr(self, attr)
            if v != 1:
                parts.append(f"{letter}{v}")
        return "".join(parts)


@dataclasses.dataclass(frozen=True)
class HybridParallelStrategy:
    """MoE hybrid: separate attention vs FFN(expert) sharding."""

    attn: ParallelStrategy
    ffn: ParallelStrategy

    def __post_init__(self):
        # the ffn spec reuses the attn devices: ep borrows dp degrees, so the
        # ffn world including ep must equal the attn world
        ffn_ws = self.ffn.dp * self.ffn.tp * self.ffn.pp * self.ffn.cp * self.ffn.ep
        if ffn_ws != self.attn.world_size:
            raise ValueError(
                f"hybrid MoE spec mismatch: attn world {self.attn.world_size} != "
                f"ffn world {ffn_ws} (dp*tp*pp*cp*ep)"
            )

    @property
    def world_size(self) -> int:
        return self.attn.world_size


@dataclasses.dataclass
class ModelAllocation:
    backend: str | None
    name: str  # role: "" (default), "r"(ollout), "a"(ctor), "c"(ritic), ...
    parallel: ParallelStrategy | HybridParallelStrategy

    @property
    def is_gen(self) -> bool:
        return self.backend in GEN_BACKENDS

    @property
    def is_train(self) -> bool:
        return self.backend is None or self.backend in TRAIN_BACKENDS

    @property
    def world_size(self) -> int:
        return self.parallel.world_size


class _Parser:
    def __init__(self, s: str):
        self.s = s.replace(" ", "")
        self.i = 0

    def error(self, msg: str):
        raise ValueError(f"allocation mode parse error at {self.i} in {self.s!r}: {msg}")

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def eat(self, ch: str):
        if self.peek() != ch:
            self.error(f"expected {ch!r}")
        self.i += 1

    def ident(self) -> str:
        m = re.match(r"[A-Za-z_][A-Za-z0-9_]*", self.s[self.i :])
        if not m:
            self.error("expected identifier")
        self.i += len(m.group())
        return m.group()

    def plain_pspec(self) -> ParallelStrategy:
        dims: dict[str, int] = {}
        matched = False
        while True:
            m = re.match(r"(et|[dtpce])(\d+)", self.s[self.i :])
            if not m:
                break
            matched = True
            key = _DIM_ALIASES[m.group(1)]
            if key in dims:
                self.error(f"duplicate dim {m.group(1)!r}")
            dims[key] = int(m.group(2))
            self.i += len(m.group())
        if not matched:
            self.error("expected parallel spec like d4t2")
        return ParallelStrategy(**dims)

    def pspec(self) -> ParallelStrategy | HybridParallelStrategy:
        if self.peek() == "(":
            self.eat("(")
            specs: dict[str, ParallelStrategy] = {}
            while True:
                part = self.ident()
                if part not in ("attn", "ffn"):
                    self.error("hybrid spec parts must be 'attn' or 'ffn'")
                self.eat(":")
                specs[part] = self.plain_pspec()
                if self.peek() == "|":
                    self.eat("|")
                    continue
                break
            self.eat(")")
            if set(specs) != {"attn", "ffn"}:
                self.error("hybrid spec needs both attn and ffn")
            return HybridParallelStrategy(attn=specs["attn"], ffn=specs["ffn"])
        return self.plain_pspec()

    def alloc(self) -> ModelAllocation:
        save = self.i
        # try backend[role]:pspec
        m = re.match(r"[A-Za-z_][A-Za-z0-9_]*", self.s[self.i :])
        if m and (
            self.s[self.i + len(m.group()) : self.i + len(m.group()) + 1] in (":", "[")
        ):
            backend = self.ident()
            name = ""
            if self.peek() == "[":
                self.eat("[")
                name = self.ident()
                self.eat("]")
            self.eat(":")
            if backend not in GEN_BACKENDS | TRAIN_BACKENDS:
                self.error(f"unknown backend {backend!r}")
            return ModelAllocation(backend=backend, name=name, parallel=self.pspec())
        self.i = save
        return ModelAllocation(backend=None, name="", parallel=self.plain_pspec())

    def group(self) -> list[ModelAllocation]:
        allocs = [self.alloc()]
        while self.peek() == "|":
            self.eat("|")
            allocs.append(self.alloc())
        return allocs

    def expr(self) -> list[list[ModelAllocation]]:
        groups = [self.group()]
        while self.peek() == "+":
            self.eat("+")
            groups.append(self.group())
        if self.i != len(self.s):
            self.error("trailing input")
        return groups


@dataclasses.dataclass
class AllocationMode:
    type_: AllocationType
    groups: list[list[ModelAllocation]]

    @classmethod
    def from_str(cls, s: str) -> "AllocationMode":
        groups = _Parser(s).expr()
        gen = [a for g in groups for a in g if a.is_gen]
        train = [a for g in groups for a in g if not a.is_gen]
        if gen and train:
            colocated = any(
                any(a.is_gen for a in g) and any(not a.is_gen for a in g)
                for g in groups
            )
            t = AllocationType.COLOCATE if colocated else AllocationType.DECOUPLED
        elif gen:
            t = AllocationType.GEN_ONLY
        else:
            t = AllocationType.TRAIN_ONLY
        return cls(type_=t, groups=groups)

    @property
    def allocations(self) -> list[ModelAllocation]:
        return [a for g in self.groups for a in g]

    def _find(self, pred) -> ModelAllocation | None:
        for a in self.allocations:
            if pred(a):
                return a
        return None

    @property
    def gen(self) -> ParallelStrategy | None:
        a = self._find(lambda a: a.is_gen)
        return a.parallel if a else None

    @property
    def train(self) -> ParallelStrategy | HybridParallelStrategy | None:
        a = self._find(lambda a: not a.is_gen and a.name in ("", "a", "actor"))
        if a is None:
            a = self._find(lambda a: not a.is_gen)
        return a.parallel if a else None

    @property
    def critic(self) -> ParallelStrategy | None:
        a = self._find(lambda a: not a.is_gen and a.name in ("c", "critic"))
        return a.parallel if a else None

    @property
    def gen_backend(self) -> str | None:
        a = self._find(lambda a: a.is_gen)
        return a.backend if a else None

    @property
    def train_backend(self) -> str | None:
        a = self._find(lambda a: not a.is_gen)
        return (a.backend or "gspmd") if a else None

    @property
    def gen_world_size(self) -> int:
        return sum(a.world_size for a in self.allocations if a.is_gen)

    @property
    def train_world_size(self) -> int:
        # colocated allocations share devices: count per group max of train allocs
        total = 0
        for g in self.groups:
            train_ws = [a.world_size for a in g if not a.is_gen]
            if train_ws:
                total += max(train_ws)
        return total

    @property
    def world_size(self) -> int:
        total = 0
        for g in self.groups:
            total += max(a.world_size for a in g)
        return total


def _mesh_config_of(ps: "ParallelStrategy | HybridParallelStrategy"):
    """ParallelStrategy -> MeshConfig (dp→fsdp: the data-parallel degree
    shards the parameters; tp→model, cp→seq, ep→expert).

    Expert parallelism reuses the data-parallel devices (reference
    fsdp_utils/parallel.py:84-121 — "EP borrows dp degrees"; world_size
    excludes ep for the same reason), so the expert axis is carved OUT of
    the dp degree: fsdp = dp / ep, keeping the mesh axis product equal to
    the allocation's world size. Hybrid specs take attention layout from
    the attn half and ep from the ffn half."""
    from areal_tpu_torch.api.config import MeshConfig

    if isinstance(ps, HybridParallelStrategy):
        dp, cp, tp, ep, pp = ps.attn.dp, ps.attn.cp, ps.attn.tp, ps.ffn.ep, ps.attn.pp
    else:
        dp, cp, tp, ep, pp = ps.dp, ps.cp, ps.tp, ps.ep, ps.pp
    if dp % ep != 0:
        raise ValueError(
            f"ep={ep} must divide dp={dp} "
            "(expert parallelism borrows data-parallel degrees)"
        )
    return MeshConfig(
        data=1, fsdp=dp // ep, seq=cp, model=tp, expert=ep, pipe=pp
    )


def apply_allocation_mode(config) -> "AllocationMode | None":
    """Make ``config.allocation_mode`` the live topology knob (reference
    alloc_mode.py:333 via rl_trainer.py:91): parse the DSL string and write
    the resulting axis sizes into the per-engine MeshConfigs, the inference
    server mesh, and the launcher's server count. No-op when the string is
    empty (engines then use their hand-set MeshConfig). Explicit non-default
    MeshConfigs win over the DSL — so examples can still override one engine.

    Works on any experiment config shaped like PPOConfig/SFTConfig: fields
    are discovered by name (actor/critic/ref/model, server, launcher).
    """
    s = getattr(config, "allocation_mode", "") or ""
    if not s:
        return None
    from areal_tpu_torch.api.config import MeshConfig

    mode = AllocationMode.from_str(s)
    default = MeshConfig()

    def _apply(engine_cfg, ps):
        if engine_cfg is None or ps is None:
            return
        if getattr(engine_cfg, "mesh", None) in (None, default):
            engine_cfg.mesh = _mesh_config_of(ps)

    train_ps = mode.train
    for name in ("actor", "ref", "model"):
        _apply(getattr(config, name, None), train_ps)
    _apply(getattr(config, "critic", None), mode.critic or train_ps)

    gen_ps = mode.gen
    server_cfg = getattr(config, "server", None)
    if gen_ps is not None and server_cfg is not None:
        # the gen layout is the train mapping with the replica axis peeled
        # off: one server per fsdp slice, each owning a cp×tp×ep chip slice
        gen_mesh = _mesh_config_of(gen_ps)
        if gen_mesh.pipe > 1:
            raise ValueError(
                "pipeline parallelism (pN) applies to training only; the "
                "decode engine serves layer-stacked weights without stage "
                "partitioning — drop pN from the gen half of allocation_mode"
            )
        n_servers = gen_mesh.fsdp
        if getattr(server_cfg, "mesh", None) == default:
            server_cfg.mesh = dataclasses.replace(gen_mesh, fsdp=1)
        launcher = getattr(config, "launcher", None)
        if launcher is not None:
            launcher.n_servers = n_servers
    return mode
