"""The rollout client: ``RemoteTorchEngine``, the one-server path of
``areal_tpu/inference/client.py`` ``RemoteJaxEngine`` on the standard
library.

It implements the ``InferenceEngine`` contract against one
``inference/server.py`` address. The heart is the interruptible
``agenerate`` loop: on stop reason "abort" (the server paused) it waits out
the pause and resubmits prompt + the tokens so far, keeping the per-token
policy versions of every attempt; the server parks the aborted request's
KV under its rid, so the resubmit resumes with zero re-prefill (or, when
the parking was evicted, prefills only the suffix past the radix-cached
pages). A request's deadline (``ModelRequest.deadline``, or
``lifecycle.default_deadline_s`` from submission) rides the
``x-areal-deadline`` header, and a 429 from the server's admission gate is
backpressure, not failure: the client waits out its Retry-After within
``lifecycle.backpressure_wait_s`` and spends no retry attempt on it. Every
post carries the calling context's ``x-areal-trace`` ids, so the server's
request timelines name the rollout they serve. Rollout submission (``submit`` / ``wait`` / ``rollout_batch`` /
``prepare_batch``) goes through the ``WorkflowExecutor``, which reads the
staleness bound against this client's version.

``agenerate`` is a coroutine on the executor's event loop, so its HTTP
calls run on asyncio streams: persistent HTTP/1.1 connections, one per
request in flight, and no thread pool that would cap how many requests
reach the server at once. Control calls (pause, version, abort) are
synchronous ``urllib`` posts.

The weight half (``client.py:1105-1498``): ``update_weights(meta, params)``
streams the trainer's state dict to the server as bf16 buckets of up to
``weight_chunk_mb`` wire bytes, staged while generation continues (bucket
i+1 encodes on one persistent encoder thread while bucket i is in flight),
then commits it inside the fence ``weight_commit_fence`` names: "hold"
(the decode loop idles one commit round trip and aborts nothing), "abort"
(the full pause) or "none". The version it commits is the client's + 1.
``update_weights`` of type "disk" posts ``/update_weights_from_disk`` with
the trainer's checkpoint directory inside the same fence. ``wire_format=
"q8"`` quantizes the dense projections before the stream with the servers'
own transform (``qwen.quantize_params_int8``): int8 tables and f32 scales,
0.58x the bf16 bytes at Qwen2.5-1.5B, served as they arrive by an int8
server and refused by any other. ``lora_only`` sends one bucket of adapter
leaves, encoded outside the fence, and posts it to
``/update_weights_lora`` inside it: the servers fold it into their base.

Later slices: more than one address, routing policies, the retry budget,
circuit breakers, the fleet probe, the weight-broadcast relay and the
failover of a draining server's 429 (ROADMAP Queue A item 8); images
(item 5).
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import threading
import time
import urllib.error
import urllib.request
import weakref
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import torch

from areal_tpu_torch.api import wire
from areal_tpu_torch.api.config import InferenceEngineConfig
from areal_tpu_torch.api.engine_api import InferenceEngine
from areal_tpu_torch.api.io_struct import (
    TIMING_FIELDS,
    ModelRequest,
    ModelResponse,
    StopReason,
    WeightUpdateMeta,
)
from areal_tpu_torch.inference.server import encode_weight_bucket
from areal_tpu_torch.models import qwen
from areal_tpu_torch.infra import workflow_context
from areal_tpu_torch.infra.workflow_executor import WorkflowExecutor
from areal_tpu_torch.observability import catalog, tracecontext
from areal_tpu_torch.utils.data import TensorDict

logger = logging.getLogger("areal_tpu_torch.client")


class _Backpressure(RuntimeError):
    """A 429 from the admission gate: ``retry_after`` seconds to wait."""

    def __init__(self, msg: str, retry_after: float):
        super().__init__(msg)
        self.retry_after = retry_after


class _ConnPool:
    """Persistent HTTP/1.1 client connections on asyncio streams, idle ones
    kept per (event loop, address). A request takes an idle connection or
    opens one, so the number in flight is bounded by the callers alone."""

    def __init__(self):
        self._idle: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()

    def _idle_list(self, addr: str) -> list:
        return self._idle.setdefault(asyncio.get_running_loop(), {}).setdefault(addr, [])

    @staticmethod
    async def _roundtrip(reader, writer, addr: str, method: str, path: str, data: bytes, extra: str):
        head = (
            f"{method} {path} HTTP/1.1\r\nHost: {addr}\r\nContent-Type: application/json\r\n"
            f"{extra}Content-Length: {len(data)}\r\n\r\n"
        )
        writer.write(head.encode("latin-1") + data)
        await writer.drain()
        status_line = await reader.readline()
        if not status_line:
            raise ConnectionResetError("connection closed before a response")
        parts = status_line.decode("latin-1").split(" ", 2)
        headers = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length") or 0)
        body = await reader.readexactly(n) if n else b""
        keep = parts[0] == "HTTP/1.1" and headers.get("connection", "").lower() != "close"
        return int(parts[1]), body, keep, headers

    async def request(
        self, addr: str, method: str, path: str, payload: dict | None, timeout: float, headers: dict | None = None
    ) -> dict:
        """One request; a 429 raises ``_Backpressure``, another status of
        400 or more RuntimeError."""
        data = json.dumps(payload).encode() if payload is not None else b""
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        idle = self._idle_list(addr)
        while True:
            reused = bool(idle)
            if reused:
                reader, writer = idle.pop()
            else:
                host, port = addr.rsplit(":", 1)
                reader, writer = await asyncio.wait_for(asyncio.open_connection(host, int(port)), timeout)
            try:
                status, body, keep, rheaders = await asyncio.wait_for(
                    self._roundtrip(reader, writer, addr, method, path, data, extra), timeout
                )
            except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
                writer.close()
                if reused:
                    continue  # the server closed an idle connection: take the next
                raise
            except BaseException:
                writer.close()  # cancelled or timed out mid-request: never reuse it
                raise
            if keep:
                idle.append((reader, writer))
            else:
                writer.close()
            if status == 429:
                try:
                    retry_after = float(rheaders.get("retry-after", "1"))
                except ValueError:
                    retry_after = 1.0
                raise _Backpressure(f"admission rejected (429) by {addr}{path}", retry_after)
            if status >= 400:
                raise RuntimeError(f"{method} {addr}{path}: HTTP {status}: {body[:200]!r}")
            return json.loads(body) if body.strip() else {}

    async def close_loop(self) -> None:
        """Close this event loop's idle connections."""
        per_addr = self._idle.pop(asyncio.get_running_loop(), {})
        for conns in per_addr.values():
            for _, writer in conns:
                writer.close()


class RemoteTorchEngine(InferenceEngine):
    """Client handle to one ``areal_tpu_torch.inference.server`` instance."""

    # metric scrapes must not inherit the long generation timeout: a dead
    # server would park the pause-wait loop for request_timeout per probe
    _SCRAPE_TIMEOUT_S = 5.0

    def __init__(self, config: InferenceEngineConfig, addresses: list[str] | None = None):
        config.check_supported()
        self.config = config
        self.addresses = list(addresses or [])
        self._check_addresses()
        self._version = 0
        self.executor = WorkflowExecutor(config, engine=self)
        self._metrics = catalog.client_metrics()
        self._robust = catalog.robustness_metrics()
        ft = config.fault_tolerance
        self._attempts = max(1, int(config.request_retries))
        self._backoff = (ft.backoff_base_s, ft.backoff_max_s, ft.backoff_jitter if ft.enabled else 0.0)
        self._rng = random.Random()
        self._http = _ConnPool()
        # in-flight rids per workflow task, so a quarantined task's
        # generations can be cancelled server-side
        self._task_rids_lock = threading.Lock()
        self._task_rids: dict[str, dict[str, str]] = {}  # task_id -> rid -> addr
        # per-task latency (the server's stage breakdown summed over the
        # task's requests), popped by the executor per trajectory. Taken ids
        # are tombstoned for a while: a quarantined task's cancelled
        # generations answer after the pop and must not re-create an entry
        self._task_latency_lock = threading.Lock()
        self._task_latency: dict[str, dict[str, float]] = {}
        self._task_latency_tombstones: OrderedDict[str, float] = OrderedDict()
        # abort posts run off the event loop on one small shared pool: a mass
        # cancel must not spawn a thread per coroutine
        self._abort_pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="abort-request")
        self.last_pause_secs = 0.0  # the last update's commit-fence window
        self.last_stage_secs = 0.0  # the last update's staging window (generation running)
        self.last_update_gen_tokens = 0  # tokens the server generated during it
        self._enc_pool: ThreadPoolExecutor | None = None  # the weight encoder thread (lazy)

    def _check_addresses(self) -> None:
        if len(self.addresses) > 1:
            raise NotImplementedError(
                f"{len(self.addresses)} server addresses (a fleet): ROADMAP Queue A item 8"
            )

    # -- lifecycle --------------------------------------------------------
    def initialize(self, addresses: list[str] | None = None, timeout: float | None = None) -> None:
        if addresses:
            self.addresses = list(addresses)
            self._check_addresses()
        if not self.addresses:
            raise NotImplementedError("server discovery through name_resolve: ROADMAP Queue A item 8")
        self._wait_healthy(timeout or self.config.setup_timeout)
        self.executor.initialize()

    def _wait_healthy(self, timeout: float) -> None:
        """Block until the server answers /health with 200. A refused
        connection means it is still booting; an HTTP error status means it
        is up but unhealthy, and is logged. The last error lands in the
        TimeoutError."""
        deadline = time.monotonic() + timeout
        for addr in self.addresses:
            last_err: BaseException | None = None
            n_http_err = 0
            while True:
                try:
                    with urllib.request.urlopen(f"http://{addr}/health", timeout=2) as r:
                        if r.status == 200:
                            break
                        last_err = RuntimeError(f"/health status {r.status}")
                except urllib.error.HTTPError as e:
                    last_err = e
                    n_http_err += 1
                    if n_http_err == 1 or n_http_err % 20 == 0:
                        logger.warning(f"server {addr} is up but /health returns {e.code}; still waiting")
                except (urllib.error.URLError, ConnectionError, OSError) as e:
                    last_err = e  # not accepting connections yet
                if time.monotonic() > deadline:
                    raise TimeoutError(f"server {addr} not healthy after {timeout:.0f}s; last error: {last_err!r}")
                time.sleep(0.5)

    def destroy(self) -> None:
        self._abort_pool.shutdown(wait=False)
        if self._enc_pool is not None:
            self._enc_pool.shutdown(wait=True)
            self._enc_pool = None
        loop = self.executor.runner._loop
        if loop is not None and loop.is_running():
            try:
                asyncio.run_coroutine_threadsafe(self._http.close_loop(), loop).result(5)
            except Exception:  # noqa: BLE001 — the runner may be going down
                pass
        self.executor.destroy()

    async def close_loop_connections(self) -> None:
        """Close the calling event loop's idle connections. A script that
        drives ``agenerate`` inside its own ``asyncio.run`` calls this before
        the loop ends; ``destroy`` reaches only the executor's loop."""
        await self._http.close_loop()

    def start_fleet_probe(self) -> None:
        raise NotImplementedError("the fleet probe: ROADMAP Queue A item 8")

    # -- per-task request tracking -----------------------------------------
    def _register_task_rid(self, rid: str, addr: str) -> str | None:
        """Track this rid under the current workflow task (if any) so a
        quarantined task's generations can be cancelled server-side.
        Returns the owning task id."""
        if not rid:
            return None
        task_id = workflow_context.get().task_id
        if not task_id:
            return None
        with self._task_rids_lock:
            self._task_rids.setdefault(task_id, {})[rid] = addr
        return task_id

    def _deregister_task_rid(self, task_id: str | None, rid: str) -> None:
        if not task_id:
            return
        with self._task_rids_lock:
            rids = self._task_rids.get(task_id)
            if rids is not None:
                rids.pop(rid, None)
                if not rids:
                    self._task_rids.pop(task_id, None)

    def abort_request(self, rid: str, addr: str | None = None) -> None:
        """Best-effort server-side cancellation of one rid (POST
        /abort_request). Never raises: cancellation is cleanup."""
        if not rid:
            return
        addr = addr or self.addresses[0]
        try:
            self._send_json_once(addr, "/abort_request", {"rid": rid}, timeout=10.0)
        except Exception as e:  # noqa: BLE001 — a dead server's slots die with it
            logger.debug(f"abort_request({rid}) on {addr} failed: {e!r}")

    def abort_task_requests(self, task_id: str) -> int:
        """Cancel every generation a workflow task still owns (the executor
        calls this when it quarantines the task). The posts run on the abort
        pool, so the executor's dispatch loop never blocks on them. Returns
        the number of rids queued for cancellation."""
        with self._task_rids_lock:
            rids = self._task_rids.pop(task_id, {})
        for rid, addr in rids.items():
            self._abort_pool.submit(self.abort_request, rid, addr)
        return len(rids)

    # -- generation -------------------------------------------------------
    async def agenerate(self, req: ModelRequest) -> ModelResponse:
        """Interruptible generation (``client.py:458``): resubmits on
        "abort" with the accumulated tokens; logprobs, versions, the
        ``min_new_tokens`` budget and the stage timings span the attempts."""
        if req.image_data is not None:
            raise NotImplementedError("image inputs: ROADMAP Queue A item 5 (vision)")
        g = req.gconfig
        accumulated: list[int] = []
        logprobs: list[float] = []
        versions: list[int] = []
        remaining = g.max_new_tokens
        start = time.monotonic()
        ttft = None
        timing = {k: 0.0 for k in TIMING_FIELDS}
        stop_reason = StopReason.ABORT.value
        truncated_by = ""
        attempt_input = list(req.input_ids)
        # the request lifecycle: the config's default deadline on a request
        # that carries none; the server reaps the slot between chunks once
        # it passes
        lc = self.config.lifecycle
        deadline = req.deadline
        if deadline is None and lc.enabled and lc.default_deadline_s:
            deadline = time.time() + lc.default_deadline_s
        headers = {}
        if deadline is not None:
            headers[wire.DEADLINE_HEADER] = f"{deadline:.6f}"
        prio = req.metadata.get("priority")
        if prio:
            headers[wire.PRIORITY_HEADER] = str(prio)
        addr = self.addresses[0]
        owner_task = self._register_task_rid(req.rid, addr)
        try:
            while True:
                payload = {
                    "input_ids": attempt_input,
                    "rid": req.rid,
                    "image_data": None,
                    "image_grid_thw": None,
                    "deadline": deadline,
                    "sampling_params": {
                        "max_new_tokens": remaining,
                        "greedy": g.greedy,
                        "temperature": g.temperature,
                        "top_p": g.top_p,
                        "top_k": g.top_k,
                        "stop_token_ids": g.stop_token_ids,
                        "max_tokens": g.max_tokens,
                        "ignore_eos": g.ignore_eos,
                        "frequency_penalty": g.frequency_penalty,
                        # tokens accumulated across attempts count toward
                        # the minimum
                        "min_new_tokens": max(0, g.min_new_tokens - len(accumulated)),
                    },
                }
                data = await self._post_json(addr, "/generate", payload, headers=headers)
                tm = data.get("timing") or {}
                for k in timing:
                    timing[k] += float(tm.get(k) or 0.0)
                toks = data["output_tokens"]
                accumulated.extend(toks)
                logprobs.extend(data["output_logprobs"])
                versions.extend(data["output_versions"])
                if ttft is None and toks:
                    # the engine's first-token stamp, placed on the client's
                    # clock by the response's receipt minus the engine's own
                    # latency (the non-streaming response lands after the
                    # whole attempt's decode)
                    eng_ttft = float(data.get("ttft") or 0.0)
                    eng_lat = float(data.get("latency") or 0.0)
                    t_end = time.monotonic()
                    if eng_ttft > 0 and eng_lat > 0:
                        ttft = max(0.0, (t_end - start) - eng_lat + eng_ttft)
                    else:
                        ttft = t_end - start
                stop_reason = data["stop_reason"]
                truncated_by = data.get("truncated_by", "") or ""
                remaining -= len(toks)
                if stop_reason != StopReason.ABORT.value or remaining <= 0:
                    if remaining <= 0 and stop_reason == StopReason.ABORT.value:
                        stop_reason = StopReason.LENGTH.value
                    break
                # the server paused: wait, then resume with the sequence so far
                await self._await_unpaused(addr)
                attempt_input = list(req.input_ids) + accumulated
        except asyncio.CancelledError:
            # the caller cancelled this coroutine (a failed task, a teardown):
            # cancel the server-side work too instead of leaving the slot
            # decoding for nobody
            try:
                self._abort_pool.submit(self.abort_request, req.rid, addr)
            except RuntimeError:
                pass  # destroy() already shut the pool down
            raise
        finally:
            self._deregister_task_rid(owner_task, req.rid)
        resp = ModelResponse(
            input_tokens=list(req.input_ids),
            output_tokens=accumulated,
            output_logprobs=logprobs,
            output_versions=versions,
            stop_reason=stop_reason,
            truncated_by=truncated_by,
            latency=time.monotonic() - start,
            ttft=ttft or (time.monotonic() - start),
            **timing,
            rid=req.rid,
            metadata=dict(req.metadata),
        )
        if owner_task is not None:
            self._note_task_latency(owner_task, resp)
        return resp

    def _note_task_latency(self, task_id: str, resp: ModelResponse) -> None:
        with self._task_latency_lock:
            if task_id in self._task_latency_tombstones:
                return  # a straggler of an already-popped task
            agg = self._task_latency.setdefault(
                task_id,
                {"requests": 0.0, "tokens": 0.0, "e2e_s": 0.0, **{k: 0.0 for k in TIMING_FIELDS}, "ttft_max_s": 0.0},
            )
            agg["requests"] += 1
            agg["tokens"] += resp.output_len
            agg["e2e_s"] += resp.latency
            for k in TIMING_FIELDS:
                agg[k] += getattr(resp, k)
            agg["ttft_max_s"] = max(agg["ttft_max_s"], resp.ttft)

    def take_task_latency(self, task_id: str) -> dict[str, float] | None:
        """Pop one workflow task's latency breakdown (None when nothing was
        recorded)."""
        now = time.monotonic()
        with self._task_latency_lock:
            self._task_latency_tombstones[task_id] = now
            ts = self._task_latency_tombstones
            while ts and (now - next(iter(ts.values())) > 600.0 or len(ts) > 65536):
                ts.popitem(last=False)
            return self._task_latency.pop(task_id, None)

    async def _await_unpaused(self, addr: str) -> None:
        while True:
            try:
                d = await self._get_json(addr, "/metrics")
                if not d.get("server_paused", d.get("paused")):
                    return
            except Exception as e:  # noqa: BLE001 — the server may be restarting
                logger.debug(f"pause-poll on {addr} failed: {e!r}")
            await asyncio.sleep(0.1)

    def _delay(self, attempt: int) -> float:
        base, cap, jitter = self._backoff
        d = min(cap, base * (2.0 ** max(0, attempt)))
        if jitter > 0:
            d *= 1.0 + self._rng.uniform(-jitter, jitter)
        return max(0.0, d)

    async def _post_json(self, addr: str, path: str, payload: dict, headers: dict | None = None) -> dict:
        """POST with ``request_retries`` tries in all and exponential backoff
        between them (``client.py:734``). A 429 is backpressure, not failure:
        the wait honors its Retry-After (scattered into [x, x*(1+jitter)])
        within ``lifecycle.backpressure_wait_s`` of wall clock and spends
        no attempt; past that budget the call fails. The calling context's
        ``x-areal-trace`` ids ride along (``client.py:745``)."""
        headers = tracecontext.inject(headers)
        lc = self.config.lifecycle
        bp_budget = lc.backpressure_wait_s if lc.enabled else 0.0
        jitter = lc.retry_after_jitter if lc.enabled else 0.0
        bp_deadline: float | None = None
        retry_after = 0.0
        last_exc: Exception | None = None
        attempt = 0  # failed attempts; a 429 is not one
        while attempt < self._attempts:
            if retry_after > 0:
                await asyncio.sleep(retry_after)
                retry_after = 0.0
            elif attempt > 0:
                self._robust.retries.labels(kind="post").inc()
                await asyncio.sleep(self._delay(attempt - 1))
            try:
                return await self._http.request(addr, "POST", path, payload, self.config.request_timeout, headers)
            except asyncio.CancelledError:
                raise
            except _Backpressure as e:
                last_exc = e
                retry_after = e.retry_after
                if jitter > 0 and retry_after > 0:
                    retry_after *= 1.0 + self._rng.random() * jitter
                now = time.monotonic()
                if bp_deadline is None:
                    bp_deadline = now + bp_budget
                if now + retry_after > bp_deadline:
                    break  # saturated past the backpressure budget
            except Exception as e:  # noqa: BLE001 — retried, then raised below
                last_exc = e
                attempt += 1
        raise RuntimeError(f"POST {addr}{path} failed after retries") from last_exc

    async def _get_json(self, addr: str, path: str) -> dict:
        """GET with a short timeout and one retry, so one dead server cannot
        stall a poll loop."""
        timeout = min(self._SCRAPE_TIMEOUT_S, self.config.request_timeout)
        last_exc: Exception | None = None
        for attempt in range(2):
            if attempt > 0:
                self._metrics.scrape_retries.inc()
                self._robust.retries.labels(kind="scrape").inc()
                await asyncio.sleep(self._delay(0))
            try:
                return await self._http.request(addr, "GET", path, None, timeout, tracecontext.inject())
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                last_exc = e
        raise RuntimeError(f"GET {addr}{path} failed after retry") from last_exc

    # -- synchronous control calls ----------------------------------------
    @staticmethod
    def _send_json_once(addr: str, path: str, payload: dict, timeout: float) -> dict:
        req = urllib.request.Request(
            f"http://{addr}{path}",
            data=json.dumps(payload).encode(),
            headers=tracecontext.inject({"Content-Type": "application/json"}),
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read() or b"{}")

    def _retry_sync(self, addr: str, path: str, send):
        """``send()`` with ``request_retries`` tries in all and backoff."""
        last_exc: Exception | None = None
        for attempt in range(self._attempts):
            if attempt > 0:
                self._robust.retries.labels(kind="fanout").inc()
                time.sleep(self._delay(attempt - 1))
            try:
                return send()
            except Exception as e:  # noqa: BLE001 — retried, then raised below
                last_exc = e
        raise RuntimeError(f"POST {addr}{path} failed after retries") from last_exc

    def _post_json_one(self, addr: str, path: str, payload: dict, timeout: float | None = None) -> dict:
        timeout = self.config.request_timeout if timeout is None else timeout
        return self._retry_sync(addr, path, lambda: self._send_json_once(addr, path, payload, timeout))

    def _post_all(self, path: str, payload: dict) -> list[dict]:
        """Synchronous POST to the server, retried in place."""
        return [self._post_json_one(addr, path, payload) for addr in self.addresses]

    def _post_bytes(self, addr: str, path: str, body) -> None:
        headers = tracecontext.inject({"Content-Type": "application/octet-stream"})

        def send():
            req = urllib.request.Request(
                f"http://{addr}{path}",
                data=body,
                headers=headers,
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=self.config.request_timeout) as r:
                r.read()

        self._retry_sync(addr, path, send)

    # -- rollout submission (the executor) ---------------------------------
    def submit(self, data: dict, workflow=None, should_accept_fn=None, is_eval=False) -> str:
        return self.executor.submit(data, workflow, should_accept_fn, is_eval=is_eval)

    def wait(self, count: int, timeout: float | None = None) -> TensorDict:
        return self.executor.wait(count, timeout)

    def wait_for_task(self, task_id: str, timeout: float | None = None):
        return self.executor.wait_for_task(task_id, timeout)

    def rollout_batch(self, data, workflow=None, should_accept_fn=None, is_eval=False) -> TensorDict:
        return self.executor.rollout_batch(data, workflow, should_accept_fn, is_eval=is_eval)

    def prepare_batch(self, dataloader, workflow=None, should_accept_fn=None) -> TensorDict:
        return self.executor.prepare_batch(dataloader, workflow, should_accept_fn)

    def pause(self) -> None:
        self.executor.pause()

    def resume(self) -> None:
        self.executor.resume()

    def set_completion_callback(self, url: str, worker_id: str = "") -> None:
        self.executor.set_completion_callback(url, worker_id)

    def attach_journal(self, journal) -> None:
        self.executor.attach_journal(journal)

    def replay_from_journal(self, max_staleness: int | None = None) -> tuple[int, int]:
        return self.executor.replay_from_journal(max_staleness)

    def set_interrupt(self, event) -> None:
        self.executor.set_interrupt(event)

    # -- server-side generation pause -------------------------------------
    def pause_generation(self, targets: list[str] | None = None, mode: str = "abort") -> None:
        """mode "abort": in-flight requests end with "abort" (their
        ``agenerate`` loops wait, then resume); the server answers once it
        has ended them. mode "hold": the commit fence; the decode loop idles
        without aborting anything and the server answers once its in-flight
        chunk drained."""
        if targets is not None:
            raise NotImplementedError("pause targets (a fleet): ROADMAP Queue A item 8")
        self._post_all("/pause_generation", {} if mode == "abort" else {"mode": mode})

    def continue_generation(self, targets: list[str] | None = None) -> None:
        if targets is not None:
            raise NotImplementedError("continue targets (a fleet): ROADMAP Queue A item 8")
        self._post_all("/continue_generation", {})

    # -- weights ----------------------------------------------------------
    def _fence_fanout(self, path: str, payload: dict, addrs: list[str], retried: bool = False) -> list[str]:
        """Post one fence leg to each of ``addrs``; never raises, returns
        those that acked. The pause leg gets one attempt of 15 s (more than
        the server's 10 s wait for the fence): a missed pause only means the
        commit lands between chunks unfenced. The continue leg gets the
        retry policy: a lost continue leaves the server held until its hold
        times out."""
        ok = []
        for a in addrs:
            try:
                r = (self._post_json_one(a, path, payload, timeout=10.0) if retried
                     else self._send_json_once(a, path, payload, 15.0))
                ok.append(a)
                if r.get("fenced") is False:
                    logger.warning(f"{a} acked the hold but its decode loop had not drained within the server's "
                                   "wait; the commit may land between its chunks unfenced")
            except Exception:  # noqa: BLE001 — the fence is best effort
                logger.warning(f"{path} to {a} failed; proceeding without it (a held server releases itself "
                               "after ServerConfig.hold_fence_timeout_s)", exc_info=True)
        return ok

    def _commit_fence(self, targets: list[str]):
        """The commit window, per ``config.weight_commit_fence``: "hold"
        fences without aborts, "abort" is the full pause, "none" commits
        with generation running (the server applies it between chunks)."""
        fence = self.config.weight_commit_fence
        if fence not in ("hold", "abort", "none"):
            raise ValueError(f"unknown weight_commit_fence {fence!r}")

        @contextmanager
        def cm():
            if fence == "none":
                yield
                return
            paused = self._fence_fanout("/pause_generation", {} if fence == "abort" else {"mode": fence}, targets)
            try:
                yield
            finally:
                self._fence_fanout("/continue_generation", {}, paused, retried=True)

        return cm()

    def _encoder_pool(self) -> ThreadPoolExecutor:
        if self._enc_pool is None:
            self._enc_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="weight-enc")
        return self._enc_pool

    def update_weights(self, meta: WeightUpdateMeta, params: dict | None = None) -> None:
        """Stream and stage every bucket while generation continues, then
        commit behind the fence (``client.py:1150``). ``params`` is the
        trainer's state dict ``{name: tensor}`` (or a nested dict of them);
        floating leaves travel as bf16, cast once here. The stage window
        (generation running), the fence window and the tokens the server
        emitted during the update are kept in ``last_stage_secs``,
        ``last_pause_secs`` and ``last_update_gen_tokens``."""
        if meta.type == "mem" and meta.lora_only:
            self._update_weights_lora(meta, params)
            return
        if meta.type == "disk":
            self._update_weights_from_disk(meta)
            return
        if meta.type != "mem":
            raise NotImplementedError(meta.type)
        if meta.wire_format not in (None, "", "bf16", "q8"):
            raise ValueError(f"unknown wire_format {meta.wire_format!r}")
        if self.config.weight_update_relay:
            raise NotImplementedError("the weight-broadcast relay: ROADMAP Queue A item 8")
        if params is None:
            raise ValueError("a mem weight update needs params")
        if meta.wire_format == "q8":
            # the servers' own transform, from the trainer's precision (no
            # bf16 rounding first; ``client.py:1300``)
            params = qwen.quantize_params_int8(params)
        version = self._version + 1 if meta.with_version else self._version
        targets = list(self.addresses)
        plan = self._plan_weight_buckets(params)
        enc_pool = self._encoder_pool()
        first = enc_pool.submit(self._encode_bucket, plan[0])
        t0 = time.monotonic()
        commit_targets = self._stream_stage_buckets(plan, enc_pool, first, targets)
        stage_secs = time.monotonic() - t0
        t1 = time.monotonic()
        replies, failed = [], []
        with self._commit_fence(commit_targets):
            for a in commit_targets:
                try:
                    replies.append(self._post_json_one(a, "/update_weights_commit", {"version": version}))
                except Exception as e:  # noqa: BLE001 — tallied below
                    failed.append((a, e))
        if failed:
            # the number is burned: a commit that failed on this side may
            # have applied on the server, and a version must never name two
            # different sets of weights
            self._version = version
            self._abort_stage_on([a for a, _ in failed])
            raise RuntimeError(
                f"weight-update commit failed on {[a for a, _ in failed]} "
                f"({len(replies)}/{len(commit_targets)} committed)"
            ) from failed[0][1]
        gen_tokens = sum(int(r.get("tokens_during_update", 0) or 0) for r in replies)
        self._finish_update(version, stage_secs, time.monotonic() - t1, gen_tokens)

    def _update_weights_lora(self, meta: WeightUpdateMeta, params: dict | None) -> None:
        """The adapter fast path (``client.py:1166``): one bucket of the
        ``layers/<t>_lora_{a,b}`` leaves, encoded outside the fence, then one
        POST to ``/update_weights_lora`` inside it; each server folds the
        delta into its base. Its kind is "lora"."""
        if not params or not all("_lora_" in k for k in params):
            raise ValueError("a lora_only update takes the layers/<t>_lora_{a,b} leaves, not the merged tree")
        if self.config.weight_update_relay:
            raise NotImplementedError("the weight-broadcast relay: ROADMAP Queue A item 8")
        version = self._version + 1 if meta.with_version else self._version
        targets = list(self.addresses)
        t_enc = time.monotonic()
        body = self._encode_bucket(sorted(params.items()))
        stage_secs = time.monotonic() - t_enc
        t0 = time.monotonic()
        with self._commit_fence(targets):
            for a in targets:
                self._post_bytes(a, f"/update_weights_lora?scale={meta.lora_scale!r}&version={version}", body)
        self._finish_update(version, stage_secs, time.monotonic() - t0, 0, kind="lora")
        self._metrics.update_bytes.inc(len(body))

    def _update_weights_from_disk(self, meta: WeightUpdateMeta) -> None:
        """Every server reloads the checkpoint the trainer wrote at
        ``meta.path`` (``client.py:1195``). The reload runs inside each
        engine's apply path, which blocks its decode loop for the whole
        load, so the fence covers it all and its window is the
        availability gap; there is no staging to split out."""
        if not meta.path:
            raise ValueError("a disk weight update needs meta.path")
        if self.config.weight_update_relay:
            raise NotImplementedError("the weight-broadcast relay: ROADMAP Queue A item 8")
        version = self._version + 1 if meta.with_version else self._version
        targets = list(self.addresses)
        t0 = time.monotonic()
        with self._commit_fence(targets):
            for a in targets:
                self._post_json_one(a, "/update_weights_from_disk", {"path": meta.path, "version": version})
        self._finish_update(version, 0.0, time.monotonic() - t0, 0, kind="disk")

    def _finish_update(self, version: int, stage_secs: float, pause_secs: float, gen_tokens: int,
                       kind: str = "mem") -> None:
        self.last_stage_secs = stage_secs
        self.last_pause_secs = pause_secs
        self.last_update_gen_tokens = gen_tokens
        self._metrics.updates.inc()
        self._metrics.pause_seconds.observe(pause_secs)
        self._metrics.stage_seconds.observe(stage_secs)
        self._metrics.commit_pause_seconds.observe(pause_secs)
        if gen_tokens:
            self._metrics.tokens_during_update.inc(gen_tokens)
        logger.info(
            f"weight update ({kind}) v{version}: staged {stage_secs:.2f}s (unpaused), commit fence "
            f"{pause_secs:.2f}s, {gen_tokens} tokens generated during the update"
        )
        self._version = version

    @staticmethod
    def _wire_nbytes(key: str, v) -> int:
        """A leaf's bytes on the wire: floats as bf16 (f32 ``_scale``
        planes stay f32), other dtypes as they are, a non-tensor 8."""
        if not isinstance(v, torch.Tensor):
            return 8
        if key.endswith("_scale"):
            return 4 * v.numel()
        return (2 if v.is_floating_point() else v.element_size()) * v.numel()

    def _plan_weight_buckets(self, params: dict) -> list[list[tuple[str, object]]]:
        """Greedy-pack the leaves, in order, into buckets of up to
        ``weight_chunk_mb`` wire bytes; a leaf larger than that gets a bucket
        to itself. Nested dicts flatten with "/" as the JAX client's do."""
        flat: list[tuple[str, object]] = []

        def walk(tree, prefix=""):
            for k, v in tree.items():
                key = f"{prefix}/{k}" if prefix else str(k)
                if isinstance(v, dict):
                    walk(v, key)
                else:
                    flat.append((key, v))

        walk(params)
        limit = max(1, self.config.weight_chunk_mb) * (1 << 20)
        buckets: list[list[tuple[str, object]]] = [[]]
        size = 0
        for key, v in flat:
            nbytes = self._wire_nbytes(key, v)
            if size and size + nbytes > limit:
                buckets.append([])
                size = 0
            buckets[-1].append((key, v))
            size += nbytes
        return buckets

    @staticmethod
    def _encode_bucket(bucket: list[tuple[str, object]]) -> bytearray:
        """Cast the floating leaves to bf16 where they live (on the card for
        the trainer's master weights) and encode the bucket; f32 ``_scale``
        planes stay f32."""
        entries = []
        for name, v in bucket:
            t = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(v)
            if t.is_floating_point() and t.dtype != torch.bfloat16 and not name.endswith("_scale"):
                t = t.to(torch.bfloat16)
            entries.append((name, t))
        return encode_weight_bucket(entries)

    def _stream_stage_buckets(self, buckets, enc_pool, first, targets: list[str]) -> list[str]:
        """The staging upload, generation running: bucket i+1 encodes while
        bucket i is in flight; ``first`` is bucket 0's encode future. On a
        failure the staged part is aborted on the server and the error
        raised. Returns the servers to commit on."""
        for a in targets:
            self._post_json_one(a, "/update_weights_begin", {})
        nxt = first
        try:
            for i in range(len(buckets)):
                body = nxt.result()
                if i + 1 < len(buckets):
                    nxt = enc_pool.submit(self._encode_bucket, buckets[i + 1])
                self._metrics.update_bytes.inc(len(body))
                for a in targets:
                    self._post_bytes(a, "/update_weights_bucket", body)
        except Exception:
            # partial buckets must not pin a second copy of the weights on
            # the server until the next begin; serving is untouched
            self._abort_stage_on(targets)
            raise
        return list(targets)

    def _abort_stage_on(self, addrs: list[str]) -> None:
        """Best-effort /update_weights_abort, one short attempt each."""
        for addr in addrs:
            try:
                self._send_json_once(addr, "/update_weights_abort", {}, 2.0)
            except Exception as e:  # noqa: BLE001 — the server may be gone
                logger.debug(f"stage-abort on {addr} failed: {e!r}")

    def set_version(self, version: int) -> None:
        self._version = version
        try:
            self._post_all("/set_version", {"version": version})
        except Exception:  # noqa: BLE001 — the server may be mid-update
            logger.warning("set_version post failed", exc_info=True)

    def get_version(self) -> int:
        return self._version

    def get_capacity(self) -> int:
        return self.executor.staleness.get_capacity()

    def export_stats(self) -> dict[str, float]:
        """The executor's rollout counters and the last weight update's
        figures."""
        stats = self.executor.export_stats()
        stats["update_weights_pause_secs"] = self.last_pause_secs
        stats["update_weights_stage_secs"] = self.last_stage_secs
        stats["generation_tokens_during_update"] = float(self.last_update_gen_tokens)
        return stats
