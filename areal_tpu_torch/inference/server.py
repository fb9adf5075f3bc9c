"""HTTP generation server over one ``DecodeEngine`` — the port of
``areal_tpu/inference/server.py`` on the standard library's
``ThreadingHTTPServer`` (no aiohttp).

Endpoints: GET ``/health``; POST ``/generate``, ``/pause_generation``,
``/continue_generation``, ``/set_version``. Request and response JSON match
the JAX server's (``_req_from_json``, ``h_generate``). There is no command
line entry yet: it needs the HF checkpoint loader, which waits for a
checkpoint in the repository; build the engine with weights in code.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from areal_tpu_torch.api.config import ServerConfig
from areal_tpu_torch.api import io_struct
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


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: "_HTTPServer"

    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        logger.debug("%s " + format, self.address_string(), *args)

    def _send(self, status: int, body: dict) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        return json.loads(raw) if raw.strip() else {}

    def do_GET(self):  # noqa: N802 — stdlib name
        engine = self.server.app.engine
        if self.path in ("/health", "/healthz"):
            self._send(200, {"status": "ok", "version": engine.get_version()})
        else:
            self._send(404, {"status": "error", "error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802 — stdlib name
        route = {
            "/generate": self.server.app.h_generate,
            "/pause_generation": self.server.app.h_pause,
            "/continue_generation": self.server.app.h_continue,
            "/set_version": self.server.app.h_set_version,
        }.get(self.path)
        if route is None:
            self._send(404, {"status": "error", "error": f"no route {self.path}"})
            return
        try:
            body = self._body()
        except (ValueError, UnicodeDecodeError):
            self._send(400, {"status": "error", "error": "unparsable JSON body"})
            return
        try:
            status, out = route(body)
        except NotImplementedError as e:
            status, out = 400, {"status": "error", "error": str(e)}
        except Exception as e:  # noqa: BLE001 — the request boundary: report, keep serving
            logger.exception(f"POST {self.path} failed")
            status, out = 500, {"status": "error", "error": f"{type(e).__name__}: {e}"}
        self._send(status, out)


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
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

    def h_pause(self, d: dict) -> tuple[int, dict]:
        self.engine.pause_generation(d.get("mode", "abort"))
        return 200, {"status": "ok"}

    def h_continue(self, d: dict) -> tuple[int, dict]:
        self.engine.continue_generation()
        return 200, {"status": "ok"}

    def h_set_version(self, d: dict) -> tuple[int, dict]:
        self.engine.set_version(int(d["version"]))
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
