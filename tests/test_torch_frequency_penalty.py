"""The frequency penalty (``ServerConfig.enable_frequency_penalty``), the
port against the JAX package and the reference math.

Mirrors ``test_config_breadth_r5.py::test_frequency_penalty_matches_reference_math``
and ``::test_frequency_penalty_survives_abort_resume`` on the same tiny
one-layer model (vocab 64, f32), the same seeded numpy weights in both
engines; the engines are driven directly (no loop thread) so an abort lands
at the same token in both. Tokens are equal and logprobs within 1e-4."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.models import qwen as jq
from areal_tpu_torch.api.config import ServerConfig, SpeculativeConfig
from areal_tpu_torch.inference import decode_engine as tde

from test_torch_kv_parking import abort_pause, drive, jax_engine, leaked, port_engine, request, step
from test_torch_qwen import jax_params, port_model

CFG = jq.ModelConfig(
    vocab_size=64,
    hidden_size=32,
    intermediate_size=64,
    num_layers=1,
    num_heads=2,
    num_kv_heads=2,
    dtype="float32",
    tie_word_embeddings=True,
)
PEN = 5.0
LOGPROB_ATOL = 1e-4
KW = dict(max_batch_size=2, max_seq_len=64, decode_steps_per_call=4, page_size=16)


@pytest.fixture(scope="module")
def weights():
    return jax_params(CFG, seed=0)


def _naive(weights, prompt, pen, n):
    """Teacher-forced greedy loop applying logits -= pen * counts (OpenAI
    semantics, generated tokens only), on the JAX model."""
    params = jax.tree.map(jnp.asarray, weights)
    ids = list(prompt)
    counts = np.zeros(CFG.vocab_size, np.float32)
    out = []
    for _ in range(n):
        a = np.asarray(ids, np.int32)[None]
        h = jq.forward(params, CFG, a, np.ones_like(a), np.arange(len(ids), dtype=np.int32)[None])
        logits = np.asarray(jq.compute_logits(params, CFG, h))[0, -1]
        tok = int(np.argmax(logits - pen * counts))
        counts[tok] += 1
        ids.append(tok)
        out.append(tok)
    return out


def _served(make, side, weights, prompt, pen, n, enable=True):
    eng = make(weights, model_cfg=CFG, enable_frequency_penalty=enable, **KW)
    out = []
    eng.submit(request(side, prompt, max_new_tokens=n, greedy=True, frequency_penalty=pen), out.append)
    drive(eng)
    return out[0]


def test_frequency_penalty_matches_reference_math(weights, caplog):
    """Greedy decode with a penalty equals the reference loop and the JAX
    engine; without the flag the port warns once and serves unpenalized."""
    n = 10
    want = _naive(weights, [1, 2, 3], PEN, n)
    assert want != _naive(weights, [1, 2, 3], 0.0, n)  # the penalty changes this stream
    j = _served(jax_engine, "jax", weights, [1, 2, 3], PEN, n)
    t = _served(port_engine, "torch", weights, [1, 2, 3], PEN, n)
    assert t.output_tokens == j.output_tokens == want
    np.testing.assert_allclose(t.output_logprobs, j.output_logprobs, atol=LOGPROB_ATOL)
    with caplog.at_level(logging.WARNING, logger="areal_tpu_torch.decode_engine"):
        off = _served(port_engine, "torch", weights, [1, 2, 3], PEN, n, enable=False)
    assert off.output_tokens == _naive(weights, [1, 2, 3], 0.0, n)
    assert sum("frequency_penalty requested" in r.message for r in caplog.records) == 1


def test_frequency_penalty_survives_abort_resume(weights):
    """One logical request across an abort: the resumed half keeps
    penalizing the tokens emitted before it (their counts are restored at
    the resume), so the whole stream equals the uninterrupted one."""
    n = 40
    res = {}
    for side, make in (("jax", jax_engine), ("torch", port_engine)):
        eng = make(weights, model_cfg=CFG, enable_frequency_penalty=True, **KW)
        out = []
        eng.submit(request(side, [1, 2, 3], max_new_tokens=n, greedy=True, frequency_penalty=PEN), out.append)
        drive(eng)
        eng.submit(request(side, [1, 2, 3], rid="fp-resume", max_new_tokens=n, greedy=True, frequency_penalty=PEN),
                   out.append)
        step(eng, 2)
        abort_pause(eng)
        eng.continue_generation()
        first = out[1]
        assert first.stop_reason == "abort" and 0 < len(first.output_tokens) < n
        eng.submit(request(side, [1, 2, 3] + first.output_tokens, rid="fp-resume",
                           max_new_tokens=n - len(first.output_tokens), greedy=True, frequency_penalty=PEN),
                   out.append)
        drive(eng)
        assert eng.stats["kv_resumes"] == 1
        assert first.output_tokens + out[2].output_tokens == out[0].output_tokens
        assert leaked(eng) == 0
        res[side] = out
    for j, t in zip(res["jax"], res["torch"]):
        assert t.output_tokens == j.output_tokens
        np.testing.assert_allclose(t.output_logprobs, j.output_logprobs, atol=LOGPROB_ATOL)


def test_penalized_and_plain_slots_in_one_chunk(weights):
    """Two penalized and two plain greedy requests decode in one batch: each
    stream equals the JAX engine's (the penalty touches only its own
    slots' logits and counts)."""
    prompts = [[1, 2, 3], [4, 5], [1, 2, 3], [7, 8, 9, 10]]
    pens = [PEN, 0.0, 0.0, 2.0]
    res = {}
    for side, make in (("jax", jax_engine), ("torch", port_engine)):
        eng = make(weights, model_cfg=CFG, enable_frequency_penalty=True, **{**KW, "max_batch_size": 4})
        out = [None] * 4
        for i, (p, pen) in enumerate(zip(prompts, pens)):
            eng.submit(request(side, p, max_new_tokens=24, greedy=True, frequency_penalty=pen),
                       lambda r, i=i: out.__setitem__(i, r))
        drive(eng)
        res[side] = out
    for j, t in zip(res["jax"], res["torch"]):
        assert t.output_tokens == j.output_tokens
        np.testing.assert_allclose(t.output_logprobs, j.output_logprobs, atol=LOGPROB_ATOL)
    assert res["torch"][0].output_tokens == _naive(weights, prompts[0], PEN, 24)
    assert res["torch"][2].output_tokens == _naive(weights, prompts[2], 0.0, 24)
    assert res["torch"][0].output_tokens != res["torch"][2].output_tokens


def test_counts_saturate_at_uint16_max(weights):
    """The count table holds uint16 values in an int16 tensor: an increment
    at 65,535 stays there (the JAX engine's saturating update), a count
    past 32,767 reads back positive, and inactive slots are not counted."""
    eng = port_engine(weights, model_cfg=CFG, enable_frequency_penalty=True, **KW)
    assert eng._freq_counts.dtype == torch.int16 and eng._freq_counts.shape == (2, CFG.vocab_size)
    assert eng.memory_bytes()["freq_counts"] == 2 * CFG.vocab_size * 2
    eng._freq_counts[0, 5] = torch.tensor(65534).to(torch.int16)
    eng._freq_counts[1, 7] = torch.tensor(40000).to(torch.int16)
    ids = torch.tensor([5, 7])
    for _ in range(3):
        eng._count_tokens(ids, torch.tensor([True, False]))
    c = eng._counts_f32()
    assert c[0, 5] == 65535 and c[1, 7] == 40000 and c.sum() == 65535 + 40000
    # a slot update (admission) zeroes the slot's row; a pending restore follows
    eng._pending_count_restore.append((1, np.bincount([3, 3, 9], minlength=CFG.vocab_size)))
    eng._apply_slot_updates([eng._pack_row(0, 1, 2, False, 0), eng._pack_row(1, 1, 2, False, 0)])
    c = eng._counts_f32()
    assert c[0].sum() == 0 and c[1, 3] == 2 and c[1, 9] == 1 and c[1].sum() == 3


def test_speculative_steps_aside_for_a_penalty(weights):
    """With speculative decoding on, a penalized request decodes on the
    sequential chunk path (no spec round while it is active) and gives the
    non-speculative penalized stream; the plain request afterwards gets
    spec rounds again."""
    cfg = ServerConfig(**KW, seed=0, enable_frequency_penalty=True, speculative=SpeculativeConfig(enabled=True))
    eng = tde.DecodeEngine(cfg, params=port_model(CFG, weights), device="cpu")
    eng.start()
    try:
        pen = eng.generate_sync(request("torch", [1, 2, 3], max_new_tokens=12, greedy=True, frequency_penalty=PEN),
                                timeout=120)
        assert eng.stats["spec_rounds"] == 0
        plain = eng.generate_sync(request("torch", [1, 2, 3], max_new_tokens=12, greedy=True), timeout=120)
    finally:
        eng.stop()
    assert pen.output_tokens == _naive(weights, [1, 2, 3], PEN, 12)
    assert plain.output_tokens == _naive(weights, [1, 2, 3], 0.0, 12)
    assert eng.stats["spec_rounds"] > 0
