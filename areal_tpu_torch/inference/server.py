"""HTTP generation server over one ``DecodeEngine`` — the port of
``areal_tpu/inference/server.py`` on the standard library's
``ThreadingHTTPServer`` (no aiohttp).

Endpoints: GET ``/health``, ``/metrics``; POST ``/generate``,
``/abort_request``, ``/pause_generation`` (``{"mode": "hold"}`` is the commit
fence: it answers ``{"fenced": bool}`` once the decode loop drained its
in-flight chunk), ``/continue_generation``, ``/set_version``,
``/flush_prefix_cache``, and the streamed weight update
``/update_weights_{begin,bucket,commit,abort}``. Request and response JSON
match the JAX server's (``_req_from_json``, ``h_generate``, ``h_metrics``,
``h_abort_request``, ``h_flush_prefix_cache``, ``h_update_*``); a bucket's
body is the JAX package's byte layout (``encode_weight_bucket``), read into
one host buffer with ``readinto`` and staged from views of it.
``/update_weights_lora`` (ROADMAP Queue A item 4), ``/update_weights_from_disk``
and ``/update_weights_from_tensors`` (item 3) and the relay header (item 8)
answer with an error naming their item. ``/metrics`` serves the JSON
shape only; its Prometheus text waits for ROADMAP Queue A item 2. There is no command
line entry yet: it needs the HF checkpoint loader, which waits for a
checkpoint in the repository; build the engine with weights in code.
"""

from __future__ import annotations

import json
import logging
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from areal_tpu_torch.api.config import ServerConfig
from areal_tpu_torch.api import io_struct, wire
from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest
from areal_tpu_torch.inference.decode_engine import DecodeEngine

logger = logging.getLogger("areal_tpu_torch.server")


def _req_from_json(d: dict) -> ModelRequest:
    g = d.get("sampling_params", {})
    gconfig = GenerationHyperparameters(
        max_new_tokens=g.get("max_new_tokens", 128),
        greedy=bool(g.get("greedy", False)),
        temperature=g.get("temperature", 1.0),
        top_p=g.get("top_p", 1.0),
        top_k=g.get("top_k", -1),
        stop_token_ids=g.get("stop_token_ids", []),
        max_tokens=g.get("max_tokens"),
        ignore_eos=bool(g.get("ignore_eos", False)),
        frequency_penalty=float(g.get("frequency_penalty", 0.0)),
        min_new_tokens=int(g.get("min_new_tokens", 0)),
    )
    if d.get("image_data"):
        raise NotImplementedError("image inputs: ROADMAP Queue A, vision")
    deadline = d.get("deadline")
    return ModelRequest(
        input_ids=d["input_ids"],
        gconfig=gconfig,
        rid=d.get("rid", ""),
        metadata=d.get("metadata", {}),
        deadline=float(deadline) if deadline is not None else None,
    )


def _response_json(resp: io_struct.ModelResponse) -> dict:
    return {
        "output_tokens": resp.output_tokens,
        "output_logprobs": resp.output_logprobs,
        "output_versions": resp.output_versions,
        "stop_reason": resp.stop_reason,
        "truncated_by": resp.truncated_by,
        "latency": resp.latency,
        "ttft": resp.ttft,
        "timing": {k: getattr(resp, k) for k in io_struct.TIMING_FIELDS},
        "cached_prefix_tokens": int(resp.metadata.get("cached_prefix_tokens") or 0),
        "rid": resp.rid,
    }


def _refuse(what: str):
    def route(d: dict):
        raise NotImplementedError(what)

    return route


# weight-update routes of the JAX server that wait for later slices
_UNPORTED_ROUTES = {
    "/update_weights_lora": _refuse("LoRA weight updates: ROADMAP Queue A item 4"),
    "/update_weights_from_disk": _refuse("weight updates from disk: ROADMAP Queue A item 3"),
    "/update_weights_from_tensors": _refuse(
        "the whole-model npz weight update: ROADMAP Queue A item 3 (the streamed update replaces it)"
    ),
}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: "_HTTPServer"

    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        logger.debug("%s " + format, self.address_string(), *args)

    def _send(self, status: int, body: dict) -> None:
        data = json.dumps(body).encode()
        try:
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            # the caller went away (a cancelled rollout): nothing to answer
            self.close_connection = True

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        return json.loads(raw) if raw.strip() else {}

    def do_GET(self):  # noqa: N802 — stdlib name
        engine = self.server.app.engine
        if self.path in ("/health", "/healthz"):
            self._send(200, {"status": "ok", "version": engine.get_version()})
        elif self.path == "/metrics":
            self._send(200, self.server.app.metrics())
        else:
            self._send(404, {"status": "error", "error": f"no route {self.path}"})

    def _read_into(self, buf: torch.Tensor) -> None:
        """Fill the uint8 tensor ``buf`` from the request body."""
        view = memoryview(buf.numpy()).cast("B")
        got = 0
        while got < len(view):
            n = self.rfile.readinto(view[got:])
            if not n:
                raise ConnectionResetError(f"body ended after {got} of {len(view)} bytes")
            got += n

    def _h_bucket(self) -> tuple[int, dict]:
        app = self.server.app
        # a failure may leave the body half read: never reuse the connection
        self.close_connection = True
        if self.headers.get(wire.RELAY_HEADER):
            raise NotImplementedError("the weight-broadcast relay: ROADMAP Queue A item 8")
        n = int(self.headers.get("Content-Length") or 0)
        head = torch.empty(8, dtype=torch.uint8)
        self._read_into(head)
        (hlen,) = struct.unpack("<Q", head.numpy().tobytes())
        hjson = torch.empty(hlen, dtype=torch.uint8)
        self._read_into(hjson)
        header = json.loads(hjson.numpy().tobytes().decode())
        # the raw buffers land at the start of the (aligned) stage buffer
        with app.engine.stage_buffer(n - 8 - hlen) as buf:
            self._read_into(buf)
            app.engine.stage_weight_bucket(bucket_tensors(header, buf))
        self.close_connection = False
        return 200, {"status": "ok"}

    def do_POST(self):  # noqa: N802 — stdlib name
        app = self.server.app
        route = {
            "/generate": app.h_generate,
            "/abort_request": app.h_abort_request,
            "/pause_generation": app.h_pause,
            "/continue_generation": app.h_continue,
            "/set_version": app.h_set_version,
            "/flush_prefix_cache": app.h_flush_prefix_cache,
            "/update_weights_begin": app.h_update_begin,
            "/update_weights_commit": app.h_update_commit,
            "/update_weights_abort": app.h_update_abort,
        }.get(self.path)
        if self.path in _UNPORTED_ROUTES:
            route = _UNPORTED_ROUTES[self.path]
        if route is None and self.path != "/update_weights_bucket":
            self._send(404, {"status": "error", "error": f"no route {self.path}"})
            return
        if route is None:
            # raw octet-stream body: a handler of its own, no JSON parse
            route, body = (lambda _: self._h_bucket()), None
        else:
            try:
                body = self._body()
            except (ValueError, UnicodeDecodeError):
                self._send(400, {"status": "error", "error": "unparsable JSON body"})
                return
            if not isinstance(body, dict):
                self._send(400, {"status": "error", "error": "the JSON body must be an object"})
                return
        try:
            status, out = route(body)
        except (NotImplementedError, ValueError) as e:
            status, out = 400, {"status": "error", "error": str(e)}
        except Exception as e:  # noqa: BLE001 — the request boundary: report, keep serving
            logger.exception(f"POST {self.path} failed")
            status, out = 500, {"status": "error", "error": f"{type(e).__name__}: {e}"}
        self._send(status, out)


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # a rollout opens one connection per request in flight (32+ at once)
    request_queue_size = 128
    app: "InferenceServer"


class InferenceServer:
    """One HTTP endpoint over one DecodeEngine replica."""

    def __init__(self, config: ServerConfig, engine: DecodeEngine | None = None, device=None):
        self.config = config
        self.engine = engine or DecodeEngine(config, device=device)
        self._httpd: _HTTPServer | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self.config.port

    @property
    def address(self) -> str:
        host = self.config.host
        ip = "127.0.0.1" if host in ("0.0.0.0", "") else host
        return f"{ip}:{self.port}"

    # -- handlers: (json body) -> (status, json) --------------------------
    def h_generate(self, d: dict) -> tuple[int, dict]:
        req = _req_from_json(d)
        done = threading.Event()
        box: list[io_struct.ModelResponse] = []

        def cb(resp):
            box.append(resp)
            done.set()

        self.engine.submit(req, cb)
        done.wait()
        return 200, _response_json(box[0])

    def metrics(self) -> dict:
        """The engine's stats plus its pause state (``server.py:199``): the
        rollout client's pause-wait polls ``server_paused``."""
        out = dict(self.engine.stats)
        out["server_paused"] = self.engine.is_paused
        out.setdefault("paused", self.engine.is_paused)
        return out

    def h_abort_request(self, d: dict) -> tuple[int, dict]:
        """Cancel one request by rid (``server.py:443``): the decode loop
        reaps it between chunks and its /generate answers with stop_reason
        "cancelled". Idempotent; unknown rids are a no-op."""
        rid = str(d.get("rid", "") or "")
        if not rid:
            return 400, {"status": "error", "error": "rid required"}
        return 200, {"status": "ok", "queued": bool(self.engine.abort_request(rid))}

    def h_pause(self, d: dict) -> tuple[int, dict]:
        """An empty body is the abort pause; ``{"mode": "hold"}`` the commit
        fence, answered once the decode loop drained its in-flight chunk
        (``server.py:546``). A body that does not parse never pauses."""
        mode = d.get("mode", "abort")
        self.engine.pause_generation(mode)
        if mode == "hold":
            return 200, {"status": "ok", "fenced": bool(self.engine.wait_fence_ack(10.0))}
        return 200, {"status": "ok"}

    def h_continue(self, d: dict) -> tuple[int, dict]:
        self.engine.continue_generation()
        return 200, {"status": "ok"}

    def h_set_version(self, d: dict) -> tuple[int, dict]:
        self.engine.set_version(int(d["version"]))
        return 200, {"status": "ok"}

    def h_flush_prefix_cache(self, d: dict) -> tuple[int, dict]:
        """Drop every radix-cached page (``server.py:327``)."""
        return 200, {"status": "ok", "freed_pages": int(self.engine.flush_prefix_cache())}

    def h_update_begin(self, d: dict) -> tuple[int, dict]:
        """Open the staging area; generation keeps running. ``{"stage_target":
        "device" | "host"}`` overrides ``weight_stage_target`` for this
        update."""
        self.engine.begin_staged_update(d.get("stage_target"))
        return 200, {"status": "ok"}

    def h_update_commit(self, d: dict) -> tuple[int, dict]:
        version = d.get("version")
        self.engine.commit_staged_weights(int(version) if version is not None else None)
        return 200, {
            "status": "ok",
            "version": self.engine.get_version(),
            # tokens emitted while the update staged: the work the update
            # did not stop
            "tokens_during_update": int(self.engine.last_update_gen_tokens),
        }

    def h_update_abort(self, d: dict) -> tuple[int, dict]:
        """Drop a partially staged update."""
        self.engine.abort_staged_update()
        return 200, {"status": "ok"}

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        """Initialize and start the engine, then bind the HTTP socket."""
        if not self.engine.initialized:
            self.engine.initialize()
        self.engine.start()
        self._httpd = _HTTPServer((self.config.host, self.config.port), _Handler)
        self._httpd.app = self
        logger.info(f"inference server on {self.address}")

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        """Stop serving (call from another thread than ``serve_forever``)
        and stop the engine."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self.engine.stop()


class ServerThread:
    """In-process server for tests and single-host runs."""

    def __init__(self, config: ServerConfig, engine: DecodeEngine | None = None, device=None):
        self.server = InferenceServer(config, engine, device=device)
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> str:
        return self.server.address

    @property
    def engine(self) -> DecodeEngine:
        return self.server.engine

    def start(self) -> None:
        self.server.start()
        self._thread = threading.Thread(
            target=self.server.serve_forever, name="http-server", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        if self._thread:
            self._thread.join(timeout=30)
            self._thread = None


# -- the weight-bucket wire format (areal_tpu/inference/server.py:802-841) --

_TORCH_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def encode_weight_bucket(entries: list[tuple[str, torch.Tensor]]) -> bytearray:
    """One bucket in the JAX package's byte layout: an 8-byte little-endian
    header length, the JSON header ``[{name, dtype, shape}]``, then every
    tensor's raw bytes in order (bf16 as its 16 bits under the name
    "bfloat16"). Each tensor is copied once, from wherever it lives (a
    card included), straight into the body."""
    # a 0-d leaf travels as shape [1], as the JAX encoder's
    # np.ascontiguousarray makes it
    header = [{"name": n, "dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape) or [1]} for n, t in entries]
    hjson = json.dumps(header).encode()
    head = struct.pack("<Q", len(hjson)) + hjson
    sizes = [t.numel() * t.element_size() for _, t in entries]
    body = bytearray(len(head) + sum(sizes))
    body[: len(head)] = head
    if sum(sizes):
        out = torch.frombuffer(body, dtype=torch.uint8)
        off = len(head)
        for (_, t), n in zip(entries, sizes):
            if n:
                out[off : off + n].copy_(t.detach().contiguous().reshape(-1).view(torch.uint8))
            off += n
    return body


def decode_weight_bucket(body) -> dict[str, torch.Tensor]:
    """A bucket (bytes-like, or a uint8 tensor) -> ``{name: tensor}``."""
    if isinstance(body, torch.Tensor):
        buf = body
    else:
        mv = memoryview(body)
        buf = torch.frombuffer(bytearray(mv) if mv.readonly else mv, dtype=torch.uint8)
    (hlen,) = struct.unpack("<Q", buf[:8].numpy().tobytes())
    header = json.loads(buf[8 : 8 + hlen].numpy().tobytes().decode())
    return bucket_tensors(header, buf[8 + hlen :])


def bucket_tensors(header: list[dict], data: torch.Tensor) -> dict[str, torch.Tensor]:
    """The tensors of a bucket's data section ``data`` (a uint8 tensor, the
    raw buffers after the header). Each is a view of ``data`` (bf16 read
    through its raw bits), or a copy where its offset does not divide by its
    element size."""
    flat = {}
    off = 0
    for ent in header:
        dtype = _TORCH_DTYPES[ent["dtype"]]
        shape = [int(d) for d in ent["shape"]]
        n = 1
        for d in shape:
            n *= d
        size = torch.empty((), dtype=dtype).element_size()
        raw = data[off : off + n * size]
        if (data.storage_offset() + off) % size:
            raw = raw.clone()
        flat[ent["name"]] = raw.view(dtype).reshape(shape) if n else torch.empty(shape, dtype=dtype)
        off += n * size
    if off != data.numel():
        raise ValueError(f"bucket size mismatch: {off} != {data.numel()}")
    return flat
