"""HTTP generation server over one ``DecodeEngine`` — the port of
``areal_tpu/inference/server.py`` on the standard library's
``ThreadingHTTPServer`` (no aiohttp).

Endpoints: GET ``/health`` (503 "draining" or "wedged"), ``/metrics``
(JSON, or the Prometheus text when ``Accept`` holds ``text/plain``),
``/statusz`` (with the request-timeline counts, the decode-loop probe's
``kernels`` summary and the ``hbm`` ledger), ``/debug/flight?timelines=N``
(the flight ring and the newest request timelines); POST
``/debug/profile?duration_s=N`` (a ``torch.profiler`` capture: 200 with its
directory, 409 while one runs, ``duration_s=0`` stops it, 400 for a value
that is not a number), ``/generate``, ``/abort_request``, ``/pause_generation``
(``{"mode": "hold"}`` is the commit fence: it answers ``{"fenced": bool}``
once the decode loop drained its in-flight chunk), ``/continue_generation``,
``/set_version``, ``/flush_prefix_cache``, ``/drain``, ``/undrain``,
``/autopilot/knobs``, ``/release_memory_occupation``,
``/resume_memory_occupation``, the streamed weight update
``/update_weights_{begin,bucket,commit,abort}``, the reload of an HF
checkpoint ``/update_weights_from_disk`` (``{"path", "version"}`` in,
``{"status", "version"}`` out), the LoRA fold
``/update_weights_lora?scale=S&version=V`` (one weight bucket of
``layers/<t>_lora_{a,b}`` leaves as its body; ``{"status", "version"}``
out) and the whole-model
``/update_weights_from_tensors`` (an npz body: the port's parameter names,
or the JAX package's "/"-joined paths of stacked layers, with an optional
``__version__``). Request and response JSON match the JAX server's
(``_req_from_json``, ``h_generate``, ``h_metrics``, ``h_statusz``,
``h_debug_flight``, ``h_debug_profile``, ``h_drain``,
``h_autopilot_knobs``, ``h_update_*``).

``/generate`` runs the request lifecycle's HTTP half: the engine's admission
gate answers 429 with a jittered ``Retry-After`` (queue depth, page headroom,
draining; each refusal lands in the flight ring), the ``x-areal-deadline``
header (absolute unix-epoch seconds) becomes the request's deadline (400
when it does not parse), ``x-areal-priority`` goes into the request's
metadata, the ``x-areal-trace`` ids go onto its timeline, and a client that
disconnects while its request runs cancels the rid. A bucket's body is the
JAX package's byte layout (``encode_weight_bucket``), read into one host
buffer with ``readinto`` and staged from views of it.

The relay header (ROADMAP Queue A item 8) answers with an error naming its
item. There is no command line
entry yet (with it comes the server's SIGTERM drainer, ROADMAP Queue A
item 7 or 8): build the engine in code, with weights or with
``ServerConfig.model_path``. ``ServerThread`` started from the main thread
arms the flight ring's SIGTERM dump.
"""

from __future__ import annotations

import io
import json
import logging
import random
import select
import socket
import struct
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from areal_tpu_torch.api.config import ServerConfig
from areal_tpu_torch.api import io_struct, wire
from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest
from areal_tpu_torch.inference.decode_engine import DecodeEngine
from areal_tpu_torch.models import convert
from areal_tpu_torch.observability import catalog, hw_accounting, tracecontext
from areal_tpu_torch.observability import timeline as tl_mod
from areal_tpu_torch.observability.metrics import get_registry
from areal_tpu_torch.utils import perf_tracer

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


def _unflatten(flat: dict) -> dict:
    """``{"a/b": v}`` -> ``{"a": {"b": v}}`` (``server.py:843``)."""
    out: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: "_HTTPServer"

    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        logger.debug("%s " + format, self.address_string(), *args)

    def _send(self, status: int, body: dict, headers: dict | None = None) -> None:
        self._send_bytes(status, json.dumps(body).encode(), "application/json", headers)

    def _send_bytes(self, status: int, data: bytes, content_type: str, headers: dict | None = None) -> None:
        try:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            # the caller went away (a cancelled rollout): nothing to answer
            self.close_connection = True

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        return json.loads(raw) if raw.strip() else {}

    def _client_gone(self) -> bool:
        """True once the caller closed its connection (a readable socket with
        nothing to read). A client sends nothing more while it waits for
        its response, so readable data means a closed connection or a
        pipelined request, which is not a disconnect."""
        try:
            readable, _, _ = select.select([self.connection], [], [], 0)
            return bool(readable) and self.connection.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True

    def do_GET(self):  # noqa: N802 — stdlib name
        app = self.server.app
        path, _, query = self.path.partition("?")
        if path == "/metrics":
            text = app.prometheus_text(self.headers.get("Accept", ""))
            if text is not None:
                self._send_bytes(200, text.encode(), "text/plain; charset=utf-8")
                return
        route = {
            "/health": app.h_health,
            "/healthz": app.h_health,
            "/metrics": lambda: (200, app.metrics()),
            "/statusz": app.h_statusz,
            "/debug/flight": lambda: app.h_debug_flight(urllib.parse.parse_qs(query)),
        }.get(path)
        if route is None:
            self._send(404, {"status": "error", "error": f"no route {path}"})
            return
        self._send(*route())

    def _read_into(self, buf: torch.Tensor) -> None:
        """Fill the uint8 tensor ``buf`` from the request body."""
        view = memoryview(buf.numpy()).cast("B")
        got = 0
        while got < len(view):
            n = self.rfile.readinto(view[got:])
            if not n:
                raise ConnectionResetError(f"body ended after {got} of {len(view)} bytes")
            got += n

    def _raw_body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

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
        path, _, query = self.path.partition("?")
        route = {
            "/generate": lambda d: app.h_generate(d, headers=self.headers, gone=self._client_gone),
            "/abort_request": app.h_abort_request,
            "/drain": app.h_drain,
            "/undrain": app.h_undrain,
            "/autopilot/knobs": lambda d: app.h_autopilot_knobs(d, headers=self.headers),
            "/release_memory_occupation": app.h_release_memory,
            "/resume_memory_occupation": app.h_resume_memory,
            "/pause_generation": app.h_pause,
            "/continue_generation": app.h_continue,
            "/set_version": app.h_set_version,
            "/flush_prefix_cache": app.h_flush_prefix_cache,
            "/update_weights_begin": app.h_update_begin,
            "/update_weights_commit": app.h_update_commit,
            "/update_weights_abort": app.h_update_abort,
            "/update_weights_from_disk": app.h_update_disk,
            "/debug/profile": lambda d: app.h_debug_profile(urllib.parse.parse_qs(query)),
        }.get(path)
        raw_routes = {
            "/update_weights_bucket": lambda _: self._h_bucket(),
            "/update_weights_from_tensors": lambda _: app.h_update_tensors(self._raw_body()),
            "/update_weights_lora": lambda _: app.h_update_lora(self._raw_body(), urllib.parse.parse_qs(query)),
        }
        if route is None and path not in raw_routes:
            self._send(404, {"status": "error", "error": f"no route {path}"})
            return
        if route is None:
            # a raw body: a handler of its own, no JSON parse
            route, body = raw_routes[path], None
        else:
            try:
                body = self._body()
            except (ValueError, UnicodeDecodeError):
                self._send(400, {"status": "error", "error": "unparsable JSON body"})
                return
            if not isinstance(body, dict):
                self._send(400, {"status": "error", "error": "the JSON body must be an object"})
                return
        headers = None
        try:
            status, out, *extra = route(body)
            headers = extra[0] if extra else None
        except (NotImplementedError, ValueError) as e:
            status, out = 400, {"status": "error", "error": str(e)}
        except Exception as e:  # noqa: BLE001 — the request boundary: report, keep serving
            logger.exception(f"POST {path} failed")
            status, out = 500, {"status": "error", "error": f"{type(e).__name__}: {e}"}
        self._send(status, out, headers)


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
        self._metrics = catalog.server_metrics()
        self._engine_obs = catalog.engine_metrics()
        self._pc_obs = catalog.prefix_cache_metrics()
        self._lc_obs = catalog.lifecycle_metrics()
        self._hw_obs = catalog.train_obs_metrics()  # the ledger's gauges
        self._started_at = time.time()
        # the engine's flight ring (the process's); the role travels inside
        # the ring, so its disk dumps name it too. The first claimant keeps it
        self._flight = getattr(self.engine, "flight", None) or tl_mod.get_flight_recorder()
        if self._flight.role == "proc":
            self._flight.role = "inference_server"

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self.config.port

    @property
    def address(self) -> str:
        host = self.config.host
        ip = "127.0.0.1" if host in ("0.0.0.0", "") else host
        return f"{ip}:{self.port}"

    # -- handlers: (json body) -> (status, json) --------------------------
    def h_health(self) -> tuple[int, dict]:
        """503 "draining" while a drain is on (the replica is leaving), 503
        "wedged" when the decode loop stopped making passes with work
        pending (``server.py:137``); else 200 "ok"."""
        version = self.engine.get_version()
        if self.engine.is_draining:
            return 503, {"status": "draining", "version": version}
        if self.engine.is_wedged():
            return 503, {"status": "wedged", "version": version}
        return 200, {"status": "ok", "version": version}

    def admission_refusal(self) -> tuple[int, dict, dict] | None:
        """The engine's admission gate (``server.py:336``): None to admit,
        else 429 with the gate's reason and snapshot, and a Retry-After
        scattered into [x, x*(1+jitter)] so refused clients do not return
        on one tick."""
        admit, reason, snap = self.engine.check_admission()
        if admit:
            return None
        lc = self.config.lifecycle
        retry_after = lc.retry_after_s or 1.0
        if lc.retry_after_jitter > 0:
            retry_after *= 1.0 + random.random() * lc.retry_after_jitter
        self._lc_obs.admission_rejected.labels(reason=reason).inc()
        self._flight.record("admission_reject", severity="warn", reason=reason, queue_depth=snap.get("queue_depth"))
        return 429, {"status": "rejected", "reason": reason, **snap}, {"Retry-After": f"{retry_after:g}"}

    def h_generate(self, d: dict, headers=None, gone=None) -> tuple:
        """One generation (``server.py:336-441``). ``headers``: the request's
        HTTP headers (the deadline and priority ride there; the deadline
        header wins over a JSON "deadline"); ``gone``: a callable that says
        whether the caller disconnected, which cancels the rid. The
        ``x-areal-trace`` ids (or none) are seated on this handler thread
        first, so the request's timeline carries them."""
        tracecontext.extract(headers or {})
        self._metrics.requests.labels(endpoint="generate").inc()
        refused = self.admission_refusal()
        if refused is not None:
            return refused
        req = _req_from_json(d)
        headers = headers or {}
        prio = headers.get(wire.PRIORITY_HEADER) or req.metadata.get("priority", "")
        if prio:
            req.metadata["priority"] = str(prio).lower()
        hdr_deadline = headers.get(wire.DEADLINE_HEADER)
        if hdr_deadline:
            try:
                req.deadline = float(hdr_deadline)
            except ValueError:
                raise ValueError("bad x-areal-deadline") from None
        done = threading.Event()
        box: list[io_struct.ModelResponse] = []

        def cb(resp):
            box.append(resp)
            done.set()

        self.engine.submit(req, cb)
        while not done.wait(0.1 if gone is not None else None):
            if gone():
                # the caller is gone: cancel the engine-side work instead of
                # decoding for nobody; the answer below goes nowhere
                self.engine.abort_request(req.rid)
                gone = None
        resp = box[0]
        if resp.output_tokens:
            self._metrics.ttft.observe(resp.ttft)
        self._metrics.request_latency.observe(resp.latency)
        return 200, _response_json(resp)

    def _refresh_gauges(self) -> None:
        """Point-in-time engine state into the registry's gauges, on the
        scrape's thread (the decode loop never touches them)."""
        eng = self.engine
        m = self._metrics
        m.paused.set(1.0 if eng.is_paused else 0.0)
        depth = eng._queue.qsize() + len(eng._backlog)
        m.queue_depth.set(depth)
        self._lc_obs.queue_depth.set(depth)
        slots = getattr(eng, "_slot_task", None)
        if slots is not None:
            self._engine_obs.batch_occupancy.set(sum(1 for t in slots if t is not None))
        self._pc_obs.pages_held.set(float(eng.prefix_cache_stats().get("pages_held", 0)))
        if eng.initialized:
            try:
                hw_accounting.observe_hbm_ledger(eng.hbm_ledger(), obs=self._hw_obs)
            except Exception:  # noqa: BLE001 — a scrape must not 500 on an
                # accounting edge (memory released, pool rebuilt)
                logger.debug("hbm ledger refresh failed", exc_info=True)

    def prometheus_text(self, accept: str) -> str | None:
        """The Prometheus text of the process registry when ``accept`` asks
        for ``text/plain``; None keeps the JSON default."""
        if "text/plain" not in accept:
            return None
        self._refresh_gauges()
        return get_registry().render_prometheus()

    def metrics(self) -> dict:
        """The engine's stats plus its pause state (``server.py:199``): the
        rollout client's pause-wait polls ``server_paused``."""
        self._refresh_gauges()
        out = dict(self.engine.stats)
        out["server_paused"] = self.engine.is_paused
        out.setdefault("paused", self.engine.is_paused)
        return out

    def h_statusz(self) -> tuple[int, dict]:
        """Identity, uptime, version and live state (``server.py:216``): every
        decode-loop counter, the radix cache, the admission snapshot, the
        drain, the autopilot's setpoints, the device bytes of the KV pool and
        the penalty's count table, the request timelines' counts, the probe's
        ``kernels`` summary and the ``hbm`` ledger."""
        self._refresh_gauges()
        eng = self.engine
        out = {
            "role": "inference_server",
            "address": self.address,
            "uptime_secs": time.time() - self._started_at,
            "version": eng.get_version(),
            "paused": eng.is_paused,
            "stats": dict(eng.stats),
            "prefix_cache": eng.prefix_cache_stats(),
            "lifecycle": eng.admission_snapshot(),
            "drain": eng.drain_status(),
            "autopilot": eng.autopilot_status(),
            "memory": eng.memory_bytes() if eng.initialized else {},
            # the same key as /debug/flight's counts (there "timelines" is
            # the list of records)
            "timeline_stats": eng.timeline.stats(),
            "kernels": eng.kernel_stats(),
        }
        if eng.initialized:
            try:
                out["hbm"] = eng.hbm_ledger()
            except Exception:  # noqa: BLE001 — statusz renders without it
                logger.debug("hbm ledger failed", exc_info=True)
        return 200, out

    def h_debug_flight(self, query: dict) -> tuple[int, dict]:
        """The flight ring and the newest completed request timelines
        (``server.py:274``); ``?timelines=N`` bounds the timelines (128 by
        default)."""
        self._metrics.requests.labels(endpoint="debug_flight").inc()
        try:
            n_tl = int(query.get("timelines", ["128"])[0])
        except ValueError:
            n_tl = 128
        out = self._flight.snapshot()
        out["address"] = self.address
        out["timeline_stats"] = self.engine.timeline.stats()
        out["timelines"] = self.engine.timeline.recent(max(0, n_tl))
        return 200, out

    def h_debug_profile(self, query: dict) -> tuple[int, dict]:
        """An on-demand ``torch.profiler`` capture (``server.py:295``):
        ``?duration_s=N`` starts one and answers with its directory at once
        (the trace lands there when the timer stops it N seconds later);
        ``duration_s=0`` stops an active capture early; one capture at a
        time (409 carrying the active directory); a value that is not a
        number answers 400."""
        self._metrics.requests.labels(endpoint="debug_profile").inc()
        try:
            duration = float(query.get("duration_s", ["5"])[0])
        except ValueError:
            return 400, {"error": "duration_s must be a number"}
        if duration <= 0:
            d = perf_tracer.stop_device_profile()
            return 200, {"status": "stopped" if d else "idle", "trace_dir": d}
        active = perf_tracer.device_profile_active()
        if active is not None:
            return 409, {"error": "profile already active", "trace_dir": active}
        try:
            d = perf_tracer.profile_for(duration)
        except RuntimeError as e:  # lost the start race
            return 409, {"error": str(e)}
        return 200, {"status": "profiling", "trace_dir": d, "duration_s": duration}

    def h_drain(self, d: dict) -> tuple[int, dict]:
        """A graceful drain (``server.py:467``): admission closes (429
        "draining"), in-flight decodes finish or park within ``budget_s``
        (default ``preemption.drain_budget_s``), and the summary with the
        page audit comes back."""
        self._metrics.requests.labels(endpoint="drain").inc()
        budget = float(d.get("budget_s", self.config.preemption.drain_budget_s))
        return 200, {"status": "ok", **self.engine.drain(budget)}

    def h_undrain(self, d: dict) -> tuple[int, dict]:
        """Call a drain off: re-open admission and resume the loop. A
        terminal drain answers 409."""
        self._metrics.requests.labels(endpoint="undrain").inc()
        if not self.engine.end_drain():
            return 409, {"status": "error", "error": "drain is terminal"}
        self.engine.continue_generation()
        return 200, {"status": "ok"}

    def h_autopilot_knobs(self, d: dict, headers=None) -> tuple[int, dict]:
        """Apply control-plane setpoints (``server.py:512``); with
        ``autopilot_token`` set, the request must carry it in
        ``x-areal-autopilot-token`` (403 otherwise)."""
        self._metrics.requests.labels(endpoint="autopilot_knobs").inc()
        token = self.config.autopilot_token
        if token and (headers or {}).get(wire.AUTOPILOT_TOKEN_HEADER) != token:
            return 403, {"status": "error", "error": "bad autopilot token"}
        return 200, {"status": "ok", **self.engine.apply_autopilot_knobs(d)}

    def h_release_memory(self, d: dict) -> tuple[int, dict]:
        """Hand the card to a colocated trainer (``server.py:722``): the
        abort pause first (a hold keeps slots live and does not qualify),
        then the weights to the host and the KV pool dropped."""
        if not self.engine.is_abort_paused:
            self.engine.pause_generation()
        self.engine.release_memory()
        return 200, {"status": "ok"}

    def h_resume_memory(self, d: dict) -> tuple[int, dict]:
        self.engine.resume_memory()
        return 200, {"status": "ok"}

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
        self._metrics.pauses.inc()
        mode = d.get("mode", "abort")
        self.engine.pause_generation(mode)
        if mode == "hold":
            return 200, {"status": "ok", "fenced": bool(self.engine.wait_fence_ack(10.0))}
        return 200, {"status": "ok"}

    def h_continue(self, d: dict) -> tuple[int, dict]:
        self._metrics.resumes.inc()
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

    def h_update_disk(self, d: dict) -> tuple[int, dict]:
        """Reload the weights from the HF checkpoint at ``path``
        (``server.py:585``); blocks until the decode loop applied it."""
        if not d.get("path"):
            raise ValueError("/update_weights_from_disk needs a path")
        version = d.get("version")
        self.engine.update_weights_from_disk(d["path"], int(version) if version is not None else None)
        return 200, {"status": "ok", "version": self.engine.get_version()}

    def h_update_lora(self, body: bytes, query: dict) -> tuple[int, dict]:
        """Fold one bucket of adapters into the served base (``server.py:670``):
        ``scale`` (alpha / rank) and an optional ``version`` in the query;
        blocks until the decode loop applied it."""
        if "scale" not in query:
            raise ValueError("/update_weights_lora needs ?scale=")
        version = query.get("version")
        self.engine.update_weights_lora(
            decode_weight_bucket(body), float(query["scale"][0]), int(version[0]) if version else None
        )
        return 200, {"status": "ok", "version": self.engine.get_version()}

    def h_update_tensors(self, body: bytes) -> tuple[int, dict]:
        """The whole model in one npz body (``server.py:593``) under the JAX
        package's paths ("layers/wq", stacked layers), converted by
        ``models/convert.py``; ``__version__`` tags later tokens."""
        try:
            loaded = np.load(io.BytesIO(body), allow_pickle=False)
        except (ValueError, OSError) as e:
            raise ValueError(f"/update_weights_from_tensors: not an npz body ({e})") from e
        version = None
        flat = {}
        for k in loaded.files:
            if k == "__version__":
                version = int(loaded[k])
            else:
                flat[k] = loaded[k]
        params = _unflatten(flat)
        if not isinstance(params.get("layers"), dict):
            raise ValueError("/update_weights_from_tensors: the body holds no JAX-layout layers/... arrays")
        self.engine.update_weights_from_params(convert.from_jax_params(params, self.engine.model_cfg), version)
        return 200, {"status": "ok", "version": self.engine.get_version()}

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
    """In-process server for tests and single-host runs. ``start`` from the
    main thread arms the flight ring's SIGTERM dump
    (``signal_dump_armed``); elsewhere it cannot and says so (False)."""

    def __init__(self, config: ServerConfig, engine: DecodeEngine | None = None, device=None):
        self.server = InferenceServer(config, engine, device=device)
        self._thread: threading.Thread | None = None
        self.signal_dump_armed = False

    @property
    def address(self) -> str:
        return self.server.address

    @property
    def engine(self) -> DecodeEngine:
        return self.server.engine

    def start(self) -> None:
        self.server.start()
        # persist the flight ring on SIGTERM: a replica killed from outside
        # still leaves its last events on disk
        self.signal_dump_armed = tl_mod.install_signal_dump()
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
