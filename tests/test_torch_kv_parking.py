"""KV parking across an abort pause, the port against the JAX package.

An aborted request with a rid keeps its KV in its slot (``_Parked``); the
same-rid resubmit of prompt + emitted resumes there with zero re-prefill,
across a weight commit too under the default ``kv_reuse_across_updates``.
The engines are driven directly (admission, one chunk, drain; no loop
thread), so both abort at the same token and the resumed tokens and
logprobs are compared one for one. The JAX engine runs on a one-device CPU
mesh; both hold ``TINY_QWEN2`` in f32 from the same seeded numpy weights.

Mirrors ``test_decode_engine.py::test_kv_resume_after_abort`` and
``::test_release_resume_memory``,
``test_paged_kv.py::test_abort_while_parked_returns_every_page`` and
``test_prefix_cache.py::test_multi_turn_readmission_after_parked_eviction_hits_radix``.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from areal_tpu.api.config import MeshConfig as JMeshConfig
from areal_tpu.api.config import ServerConfig as JServerConfig
from areal_tpu.api.io_struct import GenerationHyperparameters as JGen
from areal_tpu.api.io_struct import ModelRequest as JRequest
from areal_tpu.inference import decode_engine as jde
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu_torch.api.config import ServerConfig
from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest
from areal_tpu_torch.inference import decode_engine as tde
from areal_tpu_torch.inference import server as tserver

from test_torch_qwen import jax_params, port_model
from tpu_testing import TINY_QWEN2

PSZ = 16
LOGPROB_ATOL = 1e-4  # f32 on both sides
SERVER_KW = dict(max_batch_size=4, max_seq_len=256, page_size=PSZ, decode_steps_per_call=4, seed=0)


# ---------------------------------------------------------------------------
# helpers shared with test_torch_frequency_penalty.py and
# test_torch_request_lifecycle.py
# ---------------------------------------------------------------------------


def jax_engine(weights, model_cfg=TINY_QWEN2, **kw):
    cfg = JServerConfig(**{**SERVER_KW, **kw}, mesh=JMeshConfig(data=1))
    eng = jde.DecodeEngine(
        cfg,
        params=jax.tree.map(jnp.asarray, weights),
        model_cfg=model_cfg,
        mesh=mesh_lib.make_mesh(cfg.mesh, devices=jax.devices()[:1]),
    )
    eng.initialize()
    return eng


def port_engine(weights, model_cfg=TINY_QWEN2, **kw):
    eng = tde.DecodeEngine(ServerConfig(**{**SERVER_KW, **kw}), params=port_model(model_cfg, weights), device="cpu")
    eng.initialize()
    return eng


def gen(side: str, **kw):
    return (JGen if side == "jax" else GenerationHyperparameters)(**kw)


def request(side: str, ids, rid: str = "", **g):
    req_cls = JRequest if side == "jax" else ModelRequest
    return req_cls(input_ids=list(ids), rid=rid, gconfig=gen(side, **g)) if rid else req_cls(
        input_ids=list(ids), gconfig=gen(side, **g))


def step(eng, n_chunks: int = 1) -> None:
    """Admission, then ``n_chunks`` chunks, each drained before the next."""
    eng._apply_slot_updates(eng._admit_pending())
    for _ in range(n_chunks):
        eng._drain(eng._dispatch_chunk())


def drive(eng, max_chunks: int = 200) -> None:
    """Run the admission / chunk cycle until no slot and no queue is busy."""
    for _ in range(max_chunks):
        step(eng)
        if not any(t is not None for t in eng._slot_task) and not eng._backlog and eng._queue.empty():
            return
    raise AssertionError("the engine did not drain")


def abort_pause(eng) -> None:
    """The loop's abort-pause pass, inline: park every decoding request."""
    eng.pause_generation()
    eng._abort_all()


def leaked(eng) -> int:
    """Pool pages in use that neither the radix tree nor a parking holds. A
    parked request's full pages are in both; the port's tree lists its
    pages, the JAX tree only counts them, so there the two are summed (the
    JAX drain summary's formula, exact while nothing parked is published)."""
    if isinstance(eng, tde.DecodeEngine):
        held = set(eng._radix.pages()) if eng._radix is not None else set()
        for p in eng._parked.values():
            held.update(p.pages)
        return eng.pool.used - len(held)
    held = eng._radix.pages_held if eng._radix is not None else 0
    return eng.pool.used - held - sum(len(p.pages) for p in eng._parked.values())


# ---------------------------------------------------------------------------
# the resume
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    return jax_params(TINY_QWEN2, seed=21)


@pytest.fixture(scope="module")
def new_weights():
    return jax_params(TINY_QWEN2, seed=22)


def _sharpened(params, factor=4.0):
    """The weights with the embedding and every projection scaled: the tiny
    model's greedy tokens then depend on the KV of the context (at init
    scale they barely do), so a resume over parked old-policy KV and a
    re-prefill under the new weights give different tokens."""
    out = {**params, "embed": params["embed"] * factor, "layers": dict(params["layers"])}
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        out["layers"][name] = params["layers"][name] * factor
    return out


@pytest.fixture(scope="module")
def sharp_weights(weights):
    return _sharpened(weights)


@pytest.fixture(scope="module")
def sharp_new_weights(new_weights):
    return _sharpened(new_weights)


def _abort_then_resume(eng, side, prompt, n_first_chunks, n_new, between=None):
    """One request aborted after ``n_first_chunks`` chunks, ``between(eng)``
    run during the pause, then its same-rid resubmit: (first response,
    resumed response, stats deltas)."""
    out = []
    eng.submit(request(side, prompt, rid="resume-me", max_new_tokens=n_new, greedy=True, ignore_eos=True), out.append)
    step(eng, n_first_chunks)
    abort_pause(eng)
    assert out and out[0].stop_reason == "abort"
    assert "resume-me" in eng._parked
    if between is not None:
        between(eng)
    eng.continue_generation()
    first = out[0]
    s0 = dict(eng.stats)
    eng.submit(
        request(side, prompt + first.output_tokens, rid="resume-me",
                max_new_tokens=n_new - len(first.output_tokens), greedy=True, ignore_eos=True),
        out.append,
    )
    drive(eng)
    d = {k: eng.stats[k] - s0[k] for k in ("kv_resumes", "prefill_tokens", "prefills")}
    return first, out[1], d


def test_kv_resume_after_abort(weights):
    """The same-rid resubmit resumes from the parked KV (zero re-prefill)
    and continues the uninterrupted greedy stream, as the JAX engine's."""
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, TINY_QWEN2.vocab_size, 40).tolist()
    n_new = 40
    results = {}
    for side, make in (("jax", jax_engine), ("torch", port_engine)):
        eng = make(weights)
        first, resumed, d = _abort_then_resume(eng, side, prompt, 3, n_new)
        unint = []
        eng.submit(request(side, prompt, max_new_tokens=n_new, greedy=True, ignore_eos=True), unint.append)
        drive(eng)
        results[side] = (first, resumed, d, unint[0])
        assert d["kv_resumes"] == 1 and d["prefill_tokens"] == 0 and d["prefills"] == 0, (side, d)
        assert first.output_tokens + resumed.output_tokens == unint[0].output_tokens
        assert leaked(eng) == 0
    (jf, jr, _, ju), (tf, tr, _, tu) = results["jax"], results["torch"]
    assert tf.output_tokens == jf.output_tokens and tr.output_tokens == jr.output_tokens
    assert tu.output_tokens == ju.output_tokens
    np.testing.assert_allclose(tf.output_logprobs + tr.output_logprobs, jf.output_logprobs + jr.output_logprobs,
                               atol=LOGPROB_ATOL)


def _port_resume_over_http_commit(weights, new_weights, prompt, n_new, **kw):
    """The port's abort -> staged weight commit over HTTP -> same-rid resume:
    the engine is driven inline; the commit comes through
    /update_weights_{begin,bucket,commit} of a server whose decode loop is
    not running, so it applies inline on the handler thread."""
    import json
    import urllib.request

    from areal_tpu_torch.models import convert
    from test_torch_qwen import port_cfg

    eng = port_engine(weights, **kw)
    srv = tserver.InferenceServer(eng.config, eng)
    httpd = tserver._HTTPServer(("127.0.0.1", 0), tserver._Handler)
    httpd.app = srv
    srv._httpd = httpd
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()

    def post(path, body, raw=False):
        data = body if raw else json.dumps(body).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}{path}", data=data, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    def commit(e):
        sd = convert.from_jax_params(new_weights, port_cfg(TINY_QWEN2))
        post("/update_weights_begin", {})
        post("/update_weights_bucket", tserver.encode_weight_bucket(list(sd.items())), raw=True)
        assert post("/update_weights_commit", {"version": 1})["version"] == 1

    try:
        return eng, _abort_then_resume(eng, "torch", prompt, 3, n_new, between=commit)
    finally:
        httpd.shutdown()
        httpd.server_close()


def _jax_resume_across_update(weights, new_weights, prompt, n_new, reuse):
    jeng = jax_engine(weights, kv_reuse_across_updates=reuse)
    return _abort_then_resume(jeng, "jax", prompt, 3, n_new,
                              between=lambda e: e.update_weights_from_params(
                                  jax.tree.map(jnp.asarray, new_weights), version=1))


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse", "no-reuse"])
@pytest.mark.parametrize("path", ["params", "staged-http"])
def test_resume_across_weight_update_matches_jax(sharp_weights, sharp_new_weights, reuse, path):
    """abort -> weight update (new weights, version 1) -> same-rid resume.
    With ``kv_reuse_across_updates`` on (the default), the resume decodes on
    over the parked old-policy KV with no prefill; off, every parking is
    evicted at the commit and the resume re-prefills under the new weights.
    The two give different tokens on these weights; the port's equal the
    JAX engine's either way (logprobs too), through the in-process update
    and the staged update over HTTP."""
    weights, new_weights = sharp_weights, sharp_new_weights
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, TINY_QWEN2.vocab_size, 37).tolist()
    n_new = 32
    want = _jax_resume_across_update(weights, new_weights, prompt, n_new, reuse)
    if reuse:  # the parked and the re-prefilled resumes part on these weights
        other = _jax_resume_across_update(weights, new_weights, prompt, n_new, False)
        assert other[1].output_tokens != want[1].output_tokens
    if path == "params":
        teng = port_engine(weights, kv_reuse_across_updates=reuse)
        got = _abort_then_resume(teng, "torch", prompt, 3, n_new,
                                 between=lambda e: e.update_weights_from_params(
                                     port_model(TINY_QWEN2, new_weights), version=1))
    else:
        teng, got = _port_resume_over_http_commit(weights, new_weights, prompt, n_new, kv_reuse_across_updates=reuse)
    (jf, jr, jd), (tf, tr, td) = want, got
    assert td == jd
    if reuse:
        assert td == {"kv_resumes": 1, "prefill_tokens": 0, "prefills": 0}
    else:
        assert td["kv_resumes"] == 0 and td["prefill_tokens"] == len(prompt) + len(tf.output_tokens)
    assert tf.output_tokens == jf.output_tokens and tr.output_tokens == jr.output_tokens
    np.testing.assert_allclose(tr.output_logprobs, jr.output_logprobs, atol=LOGPROB_ATOL)
    assert tr.output_versions == jr.output_versions == [1] * len(tr.output_tokens)
    assert leaked(teng) == 0 and teng.pool_audit()["ok"]


def test_release_resume_memory(weights):
    """Release drops the weights to the host and the KV pool (and every
    parking); resume brings them back, and greedy generation equals the
    JAX engine's before and after."""
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, TINY_QWEN2.vocab_size, 8).tolist()
    jeng = jax_engine(weights)
    want = []
    jeng.submit(request("jax", prompt, max_new_tokens=6, greedy=True), want.append)
    drive(jeng)
    eng = port_engine(weights)
    eng.start()
    try:
        parked = []
        eng.submit(request("torch", prompt, rid="parked", max_new_tokens=100_000, greedy=True, ignore_eos=True),
                   parked.append)
        deadline = time.monotonic() + 60
        while eng.stats["generated_tokens"] == 0 and time.monotonic() < deadline:
            time.sleep(0.002)
        eng.pause_generation()
        assert parked and "parked" in eng._parked
        eng.release_memory()
        assert eng.cache is None and not eng._parked
        assert all(p.device.type == "cpu" for p in eng.model.parameters())
        eng.release_memory()  # idempotent
        eng.resume_memory()
        assert eng.cache is not None and eng.pool_audit()["ok"] and eng.pool.used == 0
        eng.continue_generation()
        resp = eng.generate_sync(ModelRequest(input_ids=prompt, gconfig=GenerationHyperparameters(
            max_new_tokens=6, greedy=True)), timeout=120)
    finally:
        eng.stop()
    assert resp.output_tokens == want[0].output_tokens
    np.testing.assert_allclose(resp.output_logprobs, want[0].output_logprobs, atol=LOGPROB_ATOL)
    with pytest.raises(RuntimeError, match="pause_generation"):
        eng.release_memory()  # not paused


def test_abort_while_parked_returns_every_page(weights):
    """A parked rid cancelled by abort_request frees its parked pages (they
    belong to the parking, not a slot), in both engines."""
    for side, make in (("jax", jax_engine), ("torch", port_engine)):
        eng = make(weights, max_batch_size=2)
        eng.start()
        try:
            out, done = [], threading.Event()
            eng.submit(request(side, [3, 1, 4, 1, 5, 9], rid="parked", max_new_tokens=100_000, greedy=True,
                               ignore_eos=True), lambda r: (out.append(r), done.set()))
            deadline = time.monotonic() + 60
            while not any(t is not None and t.out_tokens for t in eng._slot_task) and time.monotonic() < deadline:
                time.sleep(0.002)
            eng.pause_generation()
            assert done.wait(30) and out[0].stop_reason == "abort"
            assert eng._parked["parked"].pages
            cancelled0 = eng.stats["cancelled"]
            eng.abort_request("parked")
            eng.continue_generation()
            deadline = time.monotonic() + 30
            while "parked" in eng._parked and time.monotonic() < deadline:
                time.sleep(0.02)
            assert "parked" not in eng._parked
            assert eng.stats["cancelled"] == cancelled0 + 1
        finally:
            eng.stop()
        assert leaked(eng) == 0, side
        if side == "torch":
            assert eng.pool_audit()["ok"]


def test_multi_turn_readmission_after_parked_eviction_hits_radix(weights):
    """A parking evicted under pool pressure: the rid's next turn (prompt +
    emitted + feedback) aliases the pages published at park time instead of
    prefilling from token zero; hits, hit tokens and tokens equal JAX's."""
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, TINY_QWEN2.vocab_size, 70).tolist()
    feedback = rng.integers(0, TINY_QWEN2.vocab_size, 11).tolist()
    res = {}
    for side, make in (("jax", jax_engine), ("torch", port_engine)):
        eng = make(weights, max_seq_len=512, decode_steps_per_call=8)
        out = []
        eng.submit(request(side, prompt, rid="episode-1", max_new_tokens=64, greedy=True, ignore_eos=True),
                   out.append)
        step(eng, 3)
        abort_pause(eng)
        emitted = list(out[0].output_tokens)
        assert out[0].stop_reason == "abort" and len(emitted) >= 16 and "episode-1" in eng._parked
        published = eng.prefix_cache_stats()["pages_held"]
        assert published >= (70 + len(emitted) - 1) // PSZ - 1
        assert eng._evict_oldest_parked() is not None
        eng.continue_generation()
        eng.submit(request(side, prompt + emitted + feedback, rid="episode-1", max_new_tokens=4, greedy=True),
                   out.append)
        drive(eng)
        assert len(out) == 2 and out[1].stop_reason in ("stop", "length")
        assert eng.stats["kv_resumes"] == 0 and eng.stats["prefix_cache_hits"] == 1
        assert eng.stats["prefix_hit_tokens"] >= (70 + len(emitted)) // PSZ * PSZ - PSZ
        res[side] = (emitted, out[1], published, eng.stats["prefix_hit_tokens"])
    (je, jr, jp, jh), (te, tr, tp, th) = res["jax"], res["torch"]
    assert (te, tp, th) == (je, jp, jh)
    assert tr.output_tokens == jr.output_tokens
    np.testing.assert_allclose(tr.output_logprobs, jr.output_logprobs, atol=LOGPROB_ATOL)


def test_rid_resubmitted_with_other_ids_drops_its_parking(weights):
    """A parked rid that comes back with different ids frees its parking
    and prefills (``_try_resume``'s mismatch branch); an admission that
    finds no free slot evicts the oldest parking for one. The parkings left
    after each step, the counters and the tokens equal the JAX engine's."""
    res = {}
    for side, make in (("jax", jax_engine), ("torch", port_engine)):
        eng = make(weights, max_batch_size=3)
        out, trace = [], []
        for rid, ids in (("a", [5, 6, 7]), ("b", [8, 9, 10]), ("c", [11, 12])):
            eng.submit(request(side, ids, rid=rid, max_new_tokens=50, greedy=True, ignore_eos=True), out.append)
        step(eng, 2)
        abort_pause(eng)
        eng.continue_generation()
        trace.append((sorted(eng._parked), len(eng._free_slots())))
        eng.submit(request(side, [1, 2, 3, 4], rid="a", max_new_tokens=3, greedy=True), out.append)
        step(eng)
        trace.append((sorted(eng._parked), eng.stats["kv_resumes"]))
        resumed = [r for r in out if r.rid == "c"][0]
        eng.submit(request(side, [11, 12] + resumed.output_tokens, rid="c", max_new_tokens=5, greedy=True,
                           ignore_eos=True), out.append)
        drive(eng)
        trace.append((sorted(eng._parked), eng.stats["kv_resumes"], eng.stats["prefills"]))
        assert leaked(eng) == 0
        res[side] = (trace, [(r.rid, r.output_tokens) for r in out])
    assert res["torch"] == res["jax"]
    assert res["torch"][0][0] == (["a", "b", "c"], 0)
