"""The processes of a decode engine that serves on a ``model=m x
expert=e`` mesh.

JAX serves a mesh from one process (GSPMD places the shards); PyTorch
drives one card per process. So a ``DecodeEngine`` with ``mesh.model=m``
and ``mesh.expert=e`` is a lead (the engine the caller built, rank 0) and
m·e - 1 followers that it spawns at ``initialize``
(``torch.multiprocessing``'s spawn context). Follower r takes the r-th
card after the lead's, wrapping around the cards there are; on the CPU
every rank runs on the CPU. Rank r sits at ``coords(r, e)``: model rank
r // e, expert rank r % e (``expert`` the faster axis, as in JAX's
``MESH_AXES`` order).

The ranks form process groups of their own over a ``TCPStore`` on a free
local port (``utils/network.find_free_port``), built as process-group
objects, never as the default world: a trainer rank that already has one
can host a serving lead. One group for each axis above 1: the ``model``
group of a rank holds the ranks of its expert rank, the ``expert`` group
those of its model rank (each a ``PrefixStore`` of the one store; an axis
that spans every rank uses the whole group). NCCL when every rank has its
own card; gloo when ranks share one (NCCL refuses a duplicate GPU) or run
on the CPU. The decode program uses only ``all_reduce``
(``parallel/tensor_parallel.py``, ``models/moe.py``), which gloo also
takes on CUDA tensors.

Two host channels join the lead to each follower, both pipes carrying
pickled messages whose tensors' bytes travel out of band (no shared
memory):

- ``ctrl``: the device operations, in order. The lead's decode thread is
  the only issuer of device work: before each operation it sends the
  followers the operation and its host inputs, then every rank runs the
  same program on its own shards, so the collectives meet in the same
  order everywhere. A follower answers nothing here.
- ``aux``: requests answered by a thread of the follower, off its decode
  stream: staging a weight bucket's slices, dropping a staged update, and
  reading sizes and counters. A staged bucket's bytes go by the group's
  second communicator (``stage_pg``, gloo over the same store), one send
  of all of a follower's slices a bucket; its ``aux`` message carries their
  names, dtypes and shapes.

Faults surface: a follower that fails to start fails ``start``; a dead
follower fails the next ``send`` (and a collective on gloo at once). A
follower exits when its lead's end of ``ctrl`` closes, so a lead that dies
leaves none behind.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import math
import os
import pickle
import sys
import threading
import time
import traceback

import torch
import torch.distributed as dist

from areal_tpu_torch.utils.network import find_free_port

_HOST = "127.0.0.1"
START_TIMEOUT_S = 600.0  # a follower builds its engine: weights, KV pool


def follower_device(lead: torch.device, rank: int) -> torch.device:
    """Rank ``rank``'s device: the r-th card after the lead's (wrapping
    around the cards there are), or the CPU for a CPU lead."""
    lead = torch.device(lead)
    if lead.type != "cuda":
        return lead
    n = torch.cuda.device_count()
    return torch.device("cuda", ((lead.index or 0) + rank) % n)


def backend_for(devices: list[torch.device]) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    cuda = [d for d in devices if d.type == "cuda"]
    if len(cuda) == len(devices) and len({d.index for d in cuda}) == len(devices):
        return "nccl"
    return "gloo"


def coords(rank: int, expert: int) -> tuple[int, int]:
    """(model rank, expert rank) of serving rank ``rank`` on an ``expert``
    axis of ``expert``."""
    return divmod(rank, expert)


def _decode_group(store, rank: int, size: int, backend: str, timeout):
    if backend == "gloo":
        return dist.ProcessGroupGloo(store, rank, size, timeout)
    opts = dist.ProcessGroupNCCL.Options()
    opts._timeout = timeout
    return dist.ProcessGroupNCCL(store, rank, size, opts)


def make_group(port: int, rank: int, size: int, backend: str, timeout_s: float, expert: int = 1):
    """This rank's store, its decode program's communicators by axis
    (``{"model": ..., "expert": ...}``, None for an axis of size 1) and a
    gloo one of its own for staging weights, which moves host buffers point
    to point and never runs on the decode program's (rank 0 hosts the
    store). Not the default world: nothing here calls
    ``init_process_group``."""
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(_HOST, port, size, rank == 0, timeout=timeout, wait_for_workers=False)
    stage = dist.ProcessGroupGloo(dist.PrefixStore("stage/", store), rank, size, timeout)
    m = size // expert
    tr, er = coords(rank, expert)
    groups = {"model": None, "expert": None}
    for axis, n, own, key in (("model", m, tr, er), ("expert", expert, er, tr)):
        if n == size:  # the axis spans every rank
            groups[axis] = _decode_group(dist.PrefixStore("decode/", store), rank, size, backend, timeout)
        elif n > 1:
            groups[axis] = _decode_group(dist.PrefixStore(f"decode/{axis}/{key}/", store), own, n, backend, timeout)
    return store, groups, stage


class _WireTensor:
    """A host tensor on the wire: dtype, shape and its bytes as a numpy
    array, which pickle protocol 5 hands over out of band (one copy into
    the pipe, none into the pickle)."""

    __slots__ = ("dtype", "shape", "raw")

    def __init__(self, t: torch.Tensor):
        self.dtype = str(t.dtype).removeprefix("torch.")
        self.shape = tuple(t.shape)
        self.raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()

    def tensor(self) -> torch.Tensor:
        return torch.from_numpy(self.raw).view(getattr(torch, self.dtype)).reshape(self.shape)


def _to_wire(obj):
    if isinstance(obj, torch.Tensor):
        return _WireTensor(obj)
    if isinstance(obj, dict):
        return {k: _to_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_wire(v) for v in obj)
    return obj


def _from_wire(obj):
    if isinstance(obj, _WireTensor):
        return obj.tensor()
    if isinstance(obj, dict):
        return {k: _from_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_wire(v) for v in obj)
    return obj


_ALIGN = 16  # a packed tensor starts at a multiple of this (a dtype view needs its own alignment)


def pack(tensors: dict[str, torch.Tensor]) -> tuple[list, torch.Tensor]:
    """(layout, buffer): the tensors' names, dtypes and shapes, and their
    bytes back to back (each at an aligned offset) in one uint8 host
    buffer, to travel in one send."""
    layout, chunks, off = [], [], 0
    for n, t in tensors.items():
        raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        pad = -off % _ALIGN
        if pad:
            chunks.append(torch.zeros(pad, dtype=torch.uint8))
        layout.append((n, str(t.dtype).removeprefix("torch."), tuple(t.shape), off + pad))
        chunks.append(raw)
        off += pad + raw.numel()
    return layout, torch.cat(chunks) if chunks else torch.empty(0, dtype=torch.uint8)


def packed_nbytes(layout: list) -> int:
    if not layout:
        return 0
    _, dtype, shape, off = layout[-1]
    return off + math.prod(shape) * torch.empty((), dtype=getattr(torch, dtype)).element_size()


def unpack(layout: list, buf: torch.Tensor) -> dict[str, torch.Tensor]:
    """``pack``'s tensors as views of ``buf``."""
    out = {}
    for n, dtype, shape, off in layout:
        dt = getattr(torch, dtype)
        nbytes = math.prod(shape) * torch.empty((), dtype=dt).element_size()
        out[n] = buf[off : off + nbytes].view(dt).reshape(shape)
    return out


def dumps(obj) -> bytes:
    """``obj`` (host tensors in nested dicts, lists and tuples, and
    anything else pickle takes) as one bytes object, no shared memory."""
    return pickle.dumps(_to_wire(obj), protocol=5)


def loads(data: bytes):
    return _from_wire(pickle.loads(data))


def _send(conn, obj) -> None:
    """One message: the pickled head (with each buffer's size), then every
    out-of-band buffer (tensor and numpy bytes) as a message of its own."""
    bufs: list = []
    head = pickle.dumps(_to_wire(obj), protocol=5, buffer_callback=bufs.append)
    raws = [b.raw() for b in bufs]
    conn.send_bytes(pickle.dumps((head, [r.nbytes for r in raws]), protocol=5))
    for r in raws:
        conn.send_bytes(r)


def _recv(conn):
    head, sizes = pickle.loads(conn.recv_bytes())
    bufs = []
    for n in sizes:
        buf = bytearray(n)
        if n:
            conn.recv_bytes_into(buf)
        else:
            conn.recv_bytes()
        bufs.append(buf)
    return _from_wire(pickle.loads(head, buffers=bufs))


class ServingGroup:
    """The lead's side: spawns the followers, joins the group as rank 0 and
    owns the two channels to each follower."""

    def __init__(self, size: int, lead_device: torch.device, timeout_s: float = 300.0, expert: int = 1):
        if size < 2:
            raise ValueError(f"a serving group has at least 2 ranks, got {size}")
        if size % expert:
            raise ValueError(f"expert={expert} does not divide the serving group's {size} ranks")
        self.size = size
        self.expert = expert
        self.devices = [torch.device(lead_device)] + [follower_device(lead_device, r) for r in range(1, size)]
        self.backend = backend_for(self.devices)
        self.timeout_s = timeout_s
        self.groups: dict = {}  # this rank's communicators by axis (make_group)
        self.stage_pg = None
        self._store = None
        self._procs: list = []
        self._ctrl: list = []
        self._aux: list = []
        self._ctrl_lock = threading.Lock()
        self._aux_lock = threading.Lock()
        self.closed = False

    # -- start / stop -----------------------------------------------------
    def start(self, payloads: list[bytes]) -> None:
        """Spawn follower r with ``payloads[r - 1]`` (its engine's pickled
        arguments), join the group and wait until every follower has built
        its engine. Raises, with the follower's traceback, when one does
        not come up; the others are stopped then."""
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        port = find_free_port()
        try:
            for r in range(1, self.size):
                ctrl_lead, ctrl_f = ctx.Pipe()
                aux_lead, aux_f = ctx.Pipe()
                p = ctx.Process(
                    target=follower_main,
                    args=(r, self.size, port, self.backend, str(self.devices[r]), ctrl_f, aux_f,
                          payloads[r - 1], self.timeout_s, self.expert),
                    name=f"serving-follower-{r}",
                    daemon=True,
                )
                p.start()
                ctrl_f.close()  # EOF reaches the follower once the lead's end closes
                aux_f.close()
                self._procs.append(p)
                self._ctrl.append(ctrl_lead)
                self._aux.append(aux_lead)
            self._store, self.groups, self.stage_pg = make_group(port, 0, self.size, self.backend, self.timeout_s,
                                                                 self.expert)
            deadline = time.monotonic() + START_TIMEOUT_S
            for r, conn in enumerate(self._ctrl, start=1):
                while not conn.poll(0.2):
                    if not self._procs[r - 1].is_alive():
                        raise RuntimeError(f"serving follower {r} exited with code {self._procs[r - 1].exitcode} "
                                           "before it was ready")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"serving follower {r} not ready after {START_TIMEOUT_S:.0f}s")
                kind, body = _recv(conn)
                if kind != "ready":
                    raise RuntimeError(f"serving follower {r} failed to start:\n{body}")
        except BaseException:
            self.close(timeout=5.0)
            raise

    def close(self, timeout: float = 30.0) -> None:
        """Stop every follower: a close message, then terminate / kill what
        is still alive after ``timeout``. Idempotent."""
        if self.closed:
            return
        self.closed = True
        with self._ctrl_lock:
            for conn in self._ctrl:
                try:
                    _send(conn, ("close", ()))
                except (OSError, ValueError):
                    pass
        deadline = time.monotonic() + timeout
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)
        for conn in self._ctrl + self._aux:
            conn.close()
        self.groups, self.stage_pg = {}, None
        self._store = None

    # -- liveness -----------------------------------------------------------
    def dead(self) -> list[tuple[int, int | None]]:
        """(rank, exit code) of every follower that is not running."""
        return [(r, p.exitcode) for r, p in enumerate(self._procs, start=1) if not p.is_alive()]

    def check(self) -> None:
        gone = self.dead()
        if self.closed or gone:
            raise RuntimeError(f"serving followers gone: {gone if gone else 'group closed'}")

    def pids(self) -> list[int]:
        return [p.pid for p in self._procs]

    # -- the two channels ---------------------------------------------------
    def send(self, op: str, *args) -> None:
        """Every follower runs ``op(*args)`` next, in the order sent."""
        self.send_each(op, [args] * (self.size - 1))

    def send_each(self, op: str, per_rank: list[tuple]) -> None:
        """Follower r runs ``op(*per_rank[r - 1])``."""
        self.check()
        with self._ctrl_lock:
            try:
                for conn, args in zip(self._ctrl, per_rank):
                    _send(conn, (op, tuple(args)))
            except (OSError, ValueError) as e:
                raise RuntimeError(f"serving follower channel failed during {op!r}: {e}") from e

    def ask(self, what: str, per_rank: list[tuple] | None = None, timeout: float = 600.0) -> list:
        """Every follower's answer to ``what`` on the side channel, in rank
        order (rank 1 first); raises a follower's error."""
        with self.asking(what, per_rank, timeout) as answers:
            pass
        return answers

    @contextlib.contextmanager
    def asking(self, what: str, per_rank: list[tuple] | None = None, timeout: float = 600.0):
        """``ask`` around the caller's own work: the request goes out, the
        body of the ``with`` runs while the followers answer, and the
        answers fill the yielded list (rank 1 first) on leaving it."""
        self.check()
        per_rank = per_rank if per_rank is not None else [()] * (self.size - 1)
        with self._aux_lock:
            for conn, args in zip(self._aux, per_rank):
                _send(conn, (what, tuple(args)))
            out: list = []
            try:
                yield out
            finally:  # every answer is read, so the channel stays in step
                errors = []
                for r, conn in enumerate(self._aux, start=1):
                    deadline = time.monotonic() + timeout
                    while not conn.poll(0.2):
                        if not self._procs[r - 1].is_alive() or time.monotonic() > deadline:
                            raise RuntimeError(f"serving follower {r} did not answer {what!r}")
                    ok, body = _recv(conn)
                    out.append(body)
                    if not ok:
                        errors.append(f"serving follower {r} failed {what!r}:\n{body}")
            if errors:
                raise RuntimeError("\n".join(errors))


# ---------------------------------------------------------------------------
# the follower process
# ---------------------------------------------------------------------------


def _aux_loop(engine, conn) -> None:
    """Answer the side channel until it closes: (ok, result) per request."""
    if engine.device.type == "cuda":
        torch.cuda.set_device(engine.device)  # a thread's current card is its own
    while True:
        try:
            what, args = _recv(conn)
        except (EOFError, OSError):
            return
        try:
            body = getattr(engine, "_aux_" + what)(*args)
            _send(conn, (True, body))
        except Exception:  # noqa: BLE001 — the lead re-raises it
            _send(conn, (False, traceback.format_exc()))


def follower_main(rank, size, port, backend, device, ctrl, aux, payload, timeout_s, expert=1) -> None:
    """Follower ``rank``: join the group, build the engine's shards from
    ``payload`` (``DecodeEngine.follower_payload``), report ready, then run
    the lead's operations until it sends "close" or its channel closes."""
    logging.basicConfig(level=logging.WARNING, format=f"%(asctime)s [serving rank {rank}] %(name)s: %(message)s")
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        _, groups, stage_pg = make_group(port, rank, size, backend, timeout_s, expert)
        from areal_tpu_torch.inference.decode_engine import DecodeEngine

        engine = DecodeEngine.as_follower(loads(payload), groups, rank, size, dev)
        engine._stage_pg = stage_pg
        _send(ctrl, ("ready", engine.rank_summary()))
    except BaseException:  # noqa: BLE001 — reported to the lead, which raises
        try:
            _send(ctrl, ("error", traceback.format_exc()))
        finally:
            return
    threading.Thread(target=_aux_loop, args=(engine, aux), name=f"serving-aux-{rank}", daemon=True).start()
    code = 0
    try:
        with torch.no_grad():
            while True:
                try:
                    op, args = _recv(ctrl)
                except (EOFError, OSError):
                    break  # the lead is gone
                if op == "close":
                    break
                getattr(engine, "_op_" + op)(*args)
    except BaseException:  # noqa: BLE001 — the lead sees the exit code
        traceback.print_exc()
        code = 1
    finally:
        sys.stderr.flush()
        sys.stdout.flush()
    os._exit(code)
