"""The port's VLM engines against the JAX package on the CPU: the serving
engine's image admission (the embeddings it places, text requests without
any, image requests kept out of the duplicate split and the radix match,
and a finished image request's published pages, which a text request with
the same ids then reuses: C-ref 8), parked and evicted image requests; the
train engine with the frozen tower (``forward_batch`` / ``train_batch``:
logprobs, the tower untouched, one run per batch, the LM after two steps)
and with the trainable one (logprobs equal the frozen path's, the tower's
leaves after two steps); ``VisionRLVRWorkflow``'s rows against a stub
engine; and a vision trajectory through the journal.

Both sides hold the test's tiny VLM in f32 from the same seeded numpy
weights. Tolerances: logprobs 1e-4 (serving, as the text engines' twins)
and 5e-5 (training); tower embeddings 2e-5; after two optimizer steps
every weight within 2 x LR and 99% of each leaf but the key bias within
1e-6 (the text trainer's twin rule: Adam moves a weight with a near-zero
gradient by up to ~LR on f32 noise, and the key bias's is zero); stats 2e-4
relative. The journal's bytes are exact."""

import asyncio
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.config import MeshConfig as JMeshConfig
from areal_tpu.api.config import OptimizerConfig as JOptimizerConfig
from areal_tpu.api.config import PPOActorConfig as JPPOActorConfig
from areal_tpu.api.io_struct import FinetuneSpec as JFinetuneSpec
from areal_tpu.api.io_struct import GenerationHyperparameters as JGen
from areal_tpu.api.io_struct import ModelRequest as JRequest
from areal_tpu.api.io_struct import ModelResponse as JResponse
from areal_tpu.engine import train_engine as jte
from areal_tpu.inference import decode_engine as jde
from areal_tpu.infra import trajectory_journal as jj
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu.reward.clevr_count import clevr_count_reward_fn as jreward
from areal_tpu.utils import data as jdata
from areal_tpu.workflow.vision_rlvr import VisionRLVRWorkflow as JVisionRLVRWorkflow
from areal_tpu_torch.api.config import OptimizerConfig, PPOActorConfig, ServerConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec, GenerationHyperparameters, ModelRequest, ModelResponse
from areal_tpu_torch.engine import train_engine as tte
from areal_tpu_torch.inference import decode_engine as tde
from areal_tpu_torch.infra import trajectory_journal as tj
from areal_tpu_torch.models import convert
from areal_tpu_torch.models import vision as tv
from areal_tpu_torch.reward.clevr_count import clevr_count_reward_fn as treward
from areal_tpu_torch.workflow.vision_rlvr import VisionRLVRWorkflow

from test_torch_kv_parking import SERVER_KW, abort_pause, drive, leaked, step
from test_torch_vision import IMAGE_TOKEN, JMCFG, jax_vlm_params, port_mcfg, port_model

SERVE_LOGPROB_ATOL = 1e-4
TRAIN_LOGP_TOL = dict(atol=5e-5, rtol=5e-5)
EMBED_TOL = dict(atol=2e-5, rtol=2e-5)
STAT_RTOL = 2e-4
LR = 1e-3
GRID = [[1, 4, 6]]  # 24 patches -> 6 image-pad tokens


def _patches(seed: int, n: int = 24) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, 48)).astype(np.float32)


def _prompt(seed: int, n_text: int = 18) -> list[int]:
    """24 tokens: 1, six image pads, then text (a full 16-token page and
    more, so a finished request publishes a page)."""
    rng = np.random.default_rng(seed)
    return [1] + [IMAGE_TOKEN] * 6 + rng.integers(10, 128, n_text - 1).tolist()


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    return jax_vlm_params(seed=11)


def _engine(side: str, weights):
    if side == "jax":
        from areal_tpu.api.config import ServerConfig as JServerConfig

        cfg = JServerConfig(**SERVER_KW, mesh=JMeshConfig(data=1))
        eng = jde.DecodeEngine(cfg, params=jax.tree.map(jnp.asarray, weights), model_cfg=JMCFG,
                               mesh=mesh_lib.make_mesh(cfg.mesh, devices=jax.devices()[:1]))
    else:
        eng = tde.DecodeEngine(ServerConfig(**SERVER_KW), params=port_model(weights, port_mcfg(JMCFG)), device="cpu")
    eng.initialize()
    return eng


def _req(side: str, ids, image=None, rid: str = "", n_new: int = 4):
    g = (JGen if side == "jax" else GenerationHyperparameters)(max_new_tokens=n_new, greedy=True, ignore_eos=True)
    kw = dict(input_ids=list(ids), gconfig=g, rid=rid) if rid else dict(input_ids=list(ids), gconfig=g)
    if image is not None:
        kw.update(image_data=image, image_grid_thw=np.asarray(GRID))
    return (JRequest if side == "jax" else ModelRequest)(**kw)


def _spy(eng, box: list):
    """Record each admission group's (ids of its requests, embeddings as
    numpy) from ``_image_embeds_for``."""
    real = eng._image_embeds_for

    def spy(group, ids_np, *a):
        emb = real(group, ids_np, *a)
        box.append(([list(t.req.input_ids) for t, _ in group], None if emb is None else np.asarray(emb, np.float32)))
        return emb

    eng._image_embeds_for = spy


def _run(eng, reqs) -> list:
    out = [None] * len(reqs)
    for i, r in enumerate(reqs):
        eng.submit(r, lambda resp, i=i: out.__setitem__(i, resp))
    drive(eng)
    assert all(o is not None for o in out)
    return out


def test_image_admission_matches_jax(weights):
    """One wave of two image requests with equal ids and different images
    and a text request: the embeddings at the image-pad slots equal JAX's,
    the text request's row holds none, both image requests prefill (no
    duplicate aliasing) into KV that differs from the first image-pad
    position on. Then an image request
    never radix-matches, while a text request with an image request's ids
    does match its published pages, in both packages (C-ref 8)."""
    ids, text = _prompt(1), _prompt(2)[7:] + list(range(20, 30))
    px_a, px_b = _patches(3), _patches(4)
    res = {}
    for side in ("jax", "port"):
        eng = _engine(side, weights)
        seen: list = []
        _spy(eng, seen)
        reqs = [_req(side, ids, px_a), _req(side, ids, px_b), _req(side, text)]
        wave = [None] * 3
        for i, r in enumerate(reqs):
            eng.submit(r, lambda resp, i=i: wave.__setitem__(i, resp))
        eng._apply_slot_updates(eng._admit_pending())
        if side == "port":  # the two image requests' first pages, layer 0
            pages = [eng._slot_pages[t.slot][0] for t in eng._slot_task if t is not None][:2]
            kv = [eng.cache["k"][0][:, p].clone() for p in pages]
        drive(eng)
        shared = eng.stats.get("prefix_shared", 0)
        hits0 = eng.stats["prefix_cache_hits"]
        again = _run(eng, [_req(side, ids, px_a)])[0]  # an image request: no radix match
        hits1 = eng.stats["prefix_cache_hits"]
        alias = _run(eng, [_req(side, ids)])[0]  # text with the image request's ids
        res[side] = dict(wave=wave, seen=seen, shared=shared, hits=(hits0, hits1, eng.stats["prefix_cache_hits"]),
                         again=again, alias=alias, leaked=leaked(eng))
    j, t = res["jax"], res["port"]
    for w, g in zip(j["wave"] + [j["again"], j["alias"]], t["wave"] + [t["again"], t["alias"]]):
        assert g.output_tokens == w.output_tokens
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs, atol=SERVE_LOGPROB_ATOL)
    # the embeddings, request by request, at each prompt's positions
    slots = np.nonzero(np.asarray(ids) == IMAGE_TOKEN)[0]
    for side in ("jax", "port"):
        rows = {}
        for group_ids, emb in res[side]["seen"]:
            for r, gids in enumerate(group_ids):
                rows.setdefault(tuple(gids), []).append(None if emb is None else emb[r, : len(gids)])
        res[side]["rows"] = rows
    jr, tr = j["rows"], t["rows"]
    assert jr.keys() == tr.keys()
    for key in jr:
        for w, g in zip(jr[key], tr[key]):
            assert (w is None) == (g is None)
            if g is not None:
                np.testing.assert_allclose(g, w, **EMBED_TOL)
    first_wave = tr[tuple(ids)][:2]
    assert all(np.abs(e[slots]).min(axis=1).all() > 0 for e in first_wave)  # every slot placed
    assert not np.delete(first_wave[0], slots, axis=0).any()  # nothing else
    assert not first_wave[0][slots].tolist() == first_wave[1][slots].tolist()
    # the text request sits in the wave's group with a zero row, or alone with none
    assert all(e is None or not e.any() for e in tr[tuple(text)])
    assert tuple(ids) not in [k for k, v in tr.items() if v == [None]]
    # equal ids, different images: no aliasing, different first steps
    assert t["shared"] == j["shared"] == 0
    assert pages[0] != pages[1]
    assert torch.equal(kv[0][:, :1], kv[1][:, :1]) and not torch.equal(kv[0][:, 1:7], kv[1][:, 1:7])
    # an image request never matches; the text request with its ids does
    assert t["hits"] == j["hits"] and t["hits"][1] == t["hits"][0] and t["hits"][2] == t["hits"][1] + 1
    assert t["leaked"] == 0


@pytest.mark.parametrize("evict", [False, True], ids=["resume", "re-prefill"])
def test_parked_image_request_matches_jax(weights, evict):
    """An image request aborted mid-decode parks; its same-rid resubmit
    (prompt + tokens so far, with the image) resumes from the parked KV,
    or, with its parking evicted, prefills again through the tower: the
    tokens and logprobs of JAX's engine either way."""
    ids, px = _prompt(5), _patches(6)
    res = {}
    for side in ("jax", "port"):
        eng = _engine(side, weights)
        out: list = []
        eng.submit(_req(side, ids, px, rid="img", n_new=24), out.append)
        step(eng, 2)
        abort_pause(eng)
        if evict:
            assert eng._evict_oldest_parked() is not None
        eng.continue_generation()
        first = out[0]
        s0 = dict(eng.stats)
        eng.submit(_req(side, ids + first.output_tokens, px, rid="img", n_new=24 - len(first.output_tokens)),
                   out.append)
        drive(eng)
        res[side] = (first, out[1], eng.stats["kv_resumes"] - s0["kv_resumes"],
                     eng.stats["prefills"] - s0["prefills"])
    (jf, jr, jk, jp), (tf, tr, tk, tp) = res["jax"], res["port"]
    assert (tk, tp) == (jk, jp) == ((0, 1) if evict else (1, 0))
    assert tf.output_tokens + tr.output_tokens == jf.output_tokens + jr.output_tokens
    np.testing.assert_allclose(tf.output_logprobs + tr.output_logprobs, jf.output_logprobs + jr.output_logprobs,
                               atol=SERVE_LOGPROB_ATOL)


# ---------------------------------------------------------------------------
# the train engine
# ---------------------------------------------------------------------------


def _vlm_batch(seed=0, B=4, L=16, P=8):
    """Rows with two image-pad tokens (8 patches / merge 4) and their grid
    positions; ragged pixel counts are exercised by the last row (4
    patches: one pad token takes a zero embedding, with a warning)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 128, (B, L)).astype(np.int32)
    ids[:, 2:4] = IMAGE_TOKEN
    counts = np.full(B, P, np.int32)
    counts[-1] = 4
    pos = np.stack([np.pad(tv.grid_pos_ids([[1, 2, 4]], 2)[:c], ((0, P - c), (0, 0))) for c in counts])
    return {
        "input_ids": ids,
        "attention_mask": np.ones((B, L), bool),
        "loss_mask": np.ones((B, L), np.float32),
        "pixel_values": rng.standard_normal((B, P, 48)).astype(np.float32),
        "pixel_counts": counts,
        "pixel_pos_ids": pos.astype(np.int32),
    }


def _trainers(train_vision_tower: bool, seed=0):
    common = dict(dtype="float32", param_dtype="float32", bucket_step=64, logprob_chunk_size=48,
                  gradient_checkpointing=False, train_vision_tower=train_vision_tower)
    jcfg = JPPOActorConfig(init_from_scratch=True, mesh=JMeshConfig(data=1),
                           optimizer=JOptimizerConfig(lr=LR, lr_scheduler_type="constant"), **common)
    jeng = jte.JaxTrainEngine(jcfg, model_config=JMCFG)
    jeng.initialize(JFinetuneSpec(1, 64, 4), mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    params = jax_vlm_params(seed=seed)
    jeng.params = jax.tree.map(lambda old, new: jax.device_put(jnp.asarray(new), old.sharding), jeng.params, params)
    tcfg = PPOActorConfig(attn_impl="pallas", optimizer=OptimizerConfig(lr=LR, lr_scheduler_type="constant"),
                          **common)
    teng = tte.TorchTrainEngine(tcfg, model_config=port_mcfg(JMCFG), device="cpu")
    teng.initialize(FinetuneSpec(1, 64, 4))
    teng.model.load_state_dict(convert.from_jax_params(params, teng.model.cfg))
    return jeng, teng


def _jloss(o, b):
    lm = (b["label_valid"] & (b["loss_mask"] > 0)).astype(jnp.float32)
    return -(o["logprobs"] * lm).sum() / jnp.maximum(lm.sum(), 1), {}


def _tloss(o, b):
    lm = (b["label_valid"] & (b["loss_mask"] > 0)).float()
    return -(o["logprobs"] * lm).sum() / lm.sum().clamp(min=1), {}


def _wfn(d):
    return float(len(np.asarray(d["input_ids"]))) or 1.0


def _flat(params) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(params)}


def _check_after_steps(teng, jeng, init: dict, tower_moves: bool) -> None:
    got = _flat(convert.to_jax_params(teng.model.state_dict(), teng.model.cfg))
    want = _flat(jax.tree.map(np.asarray, jeng.params))
    assert got.keys() == want.keys()
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 2 * LR, (k, diff.max())
        # the key bias's exact gradient is zero (the softmax ignores a shift
        # of every logit of a row), so Adam steps it on f32 noise alone
        assert k == "['layers']['bk']" or np.mean(diff <= 1e-6) > 0.99, (k, diff.max())
        moved = np.abs(got[k] - init[k]).max() > 0
        if k.startswith("['vision']"):
            assert moved == tower_moves, k
            if not tower_moves:
                np.testing.assert_array_equal(got[k], init[k])
        elif k not in ("['embed']",):  # rows of tokens the batch never reads stay
            assert moved, k


def test_frozen_tower_matches_jax(monkeypatch):
    """``forward_batch`` logprobs; the tower runs once for a
    ``forward_batch`` and a ``train_batch`` of the same batch (and again
    for a new batch object); two ``train_batch`` steps: loss and gradient
    norm, the tower unchanged, no AdamW state for it, every LM weight
    moved as JAX's."""
    jeng, teng = _trainers(False)
    batch = _vlm_batch(1)
    calls = []
    real = tv.vision_forward_batch
    monkeypatch.setattr(tv, "vision_forward_batch", lambda *a: calls.append(1) or real(*a))
    np.testing.assert_allclose(teng.forward_batch(batch), jeng.forward_batch(batch), **TRAIN_LOGP_TOL)
    init = _flat(convert.to_jax_params(teng.model.state_dict(), teng.model.cfg))
    assert not any(n.startswith("vision.") for n in teng._train_names)
    assert len(teng._opt.mu) == len(teng._train_names)
    for step_i in range(2):
        want = jeng.train_batch(batch, _jloss, _wfn)
        got = teng.train_batch(batch, _tloss, _wfn)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=STAT_RTOL, err_msg=f"step {step_i}: {k}")
    assert len(calls) == 1  # one batch object, one version: memoised
    teng.forward_batch(dict(batch, pixel_values=batch["pixel_values"].copy()))
    assert len(calls) == 2
    _check_after_steps(teng, jeng, init, tower_moves=False)
    # the image matters
    other = dict(batch, pixel_values=batch["pixel_values"] + 3.0)
    assert not np.allclose(teng.forward_batch(other), teng.forward_batch(batch))


def test_trainable_tower_matches_jax():
    """With ``train_vision_tower`` the logprobs equal the frozen path's at
    the same weights (and JAX's); after two steps the tower has moved as
    JAX's tower did."""
    jeng, teng = _trainers(True)
    _, frozen = _trainers(False)
    batch = _vlm_batch(2, B=3)
    lp = teng.forward_batch(batch)
    np.testing.assert_allclose(lp, frozen.forward_batch(batch), **TRAIN_LOGP_TOL)
    np.testing.assert_allclose(lp, jeng.forward_batch(batch), **TRAIN_LOGP_TOL)
    assert any(n.startswith("vision.layers.") for n in teng._train_names)
    grids = teng._make_grids(batch)
    dev = teng._grid_to_device(grids[0])
    assert dev["pixel_values"].shape[0] == 8  # three sequences bucketed to 8 rows
    assert int((dev["image_slot"] >= 0).sum()) == 2 + 2 + 1
    init = _flat(convert.to_jax_params(teng.model.state_dict(), teng.model.cfg))
    for step_i in range(2):
        want = jeng.train_batch(batch, _jloss, _wfn)
        got = teng.train_batch(batch, _tloss, _wfn)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=STAT_RTOL, err_msg=f"step {step_i}: {k}")
    _check_after_steps(teng, jeng, init, tower_moves=True)


def test_trainer_refusals():
    """What JAX refuses: a trainable tower with LoRA, or without a tower;
    tree training with images."""
    with pytest.raises(ValueError, match="LoRA"):
        tte.TorchTrainEngine(PPOActorConfig(train_vision_tower=True, lora_rank=2), model_config=port_mcfg(JMCFG),
                             device="cpu").initialize()
    text = dataclasses.replace(port_mcfg(JMCFG), vision=None, image_token_id=-1)
    with pytest.raises(ValueError, match="no vision tower"):
        tte.TorchTrainEngine(PPOActorConfig(train_vision_tower=True), model_config=text, device="cpu").initialize()
    eng = tte.TorchTrainEngine(PPOActorConfig(tree_training=True), model_config=port_mcfg(JMCFG), device="cpu")
    eng.initialize()
    with pytest.raises(ValueError, match="vision"):
        eng.train_batch(_vlm_batch(), _tloss, _wfn)


# ---------------------------------------------------------------------------
# the workflow and the journal
# ---------------------------------------------------------------------------


class _Processor:
    """A seeded stand-in for an HF processor: ids with the image pads,
    patches and the grid; ``image_processor.merge_size`` 2."""

    class image_processor:  # noqa: N801
        merge_size = 2

    def __call__(self, images, text, padding, return_tensors):
        seed = int(images[0])
        return {"input_ids": np.asarray([_prompt(seed)]), "pixel_values": _patches(seed)[None],
                "image_grid_thw": np.asarray(GRID)}


class _Tokenizer:
    def decode(self, ids, skip_special_tokens=False):
        return "the count is [3]" if sum(ids) % 2 else "no answer"


class _StubEngine:
    def __init__(self, response_cls):
        self.response_cls = response_cls
        self.requests = []

    async def agenerate(self, req):
        self.requests.append(req)
        k = len(self.requests)
        return self.response_cls(input_tokens=req.input_ids, output_tokens=[20 + k, 21], output_logprobs=[-0.5, -0.25],
                                 output_versions=[0, 1], stop_reason="stop")


def test_workflow_rows_match_jax():
    """``arun_episode`` on one CLEVR-style row: the same trajectories as
    JAX's workflow (the patches, counts and grid positions ride along), and
    every request carries the image."""
    row = {"messages": "How many objects?", "images": [7], "answer": "3"}
    rows = {}
    for side, wf_cls, eng_cls, gen_cls, reward in (
        ("jax", JVisionRLVRWorkflow, JResponse, JGen, jreward),
        ("port", VisionRLVRWorkflow, ModelResponse, GenerationHyperparameters, treward),
    ):
        eng = _StubEngine(eng_cls)
        wf = wf_cls(reward, gen_cls(n_samples=2, max_new_tokens=2), _Tokenizer(), _Processor())
        rows[side] = asyncio.run(wf.arun_episode(eng, row))
        assert all(r.image_data is not None and np.asarray(r.image_grid_thw).tolist() == GRID for r in eng.requests)
    assert len(rows["port"]) == len(rows["jax"]) == 2
    for g, w in zip(rows["port"], rows["jax"]):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
    assert {float(r["rewards"]) for r in rows["port"]} == {0.0, 1.0}


def test_vision_trajectory_journal_round_trip(tmp_path):
    """A padded batch of vision trajectories (ragged pixel keys) appended
    by both packages: byte-identical segments, and the port's scan returns
    every key bit for bit."""
    trajs = [dict(_vision_row(s)) for s in (1, 2)]
    batch = jdata.pad_sequences_to_tensors(trajs)
    for side, mod in (("jax", jj), ("port", tj)):
        j = mod.TrajectoryJournal(str(tmp_path / side), fsync=False)
        j.append_trajectory(batch, "task-0", 3, 4, int(batch["attention_mask"].sum()))
        j.close()
    files = {s: {p: open(os.path.join(tmp_path, s, p), "rb").read() for p in sorted(os.listdir(tmp_path / s))}
             for s in ("jax", "port")}
    assert files["port"] == files["jax"]
    (entry,) = tj.TrajectoryJournal(str(tmp_path / "jax"), fsync=False).scan()
    assert entry.traj.keys() == batch.keys()
    for k, v in batch.items():
        np.testing.assert_array_equal(entry.traj[k], v)
        assert entry.traj[k].dtype == v.dtype
    assert entry.traj["pixel_values"].shape == (2, 24, 48)


def _vision_row(seed: int) -> dict:
    ids = _prompt(seed)[: 10 + seed]
    n = 16 + 4 * seed
    return {"input_ids": np.asarray(ids, np.int32), "loss_mask": np.ones(len(ids), np.float32),
            "rewards": np.float32(seed), "pixel_values": _patches(seed, n), "pixel_counts": np.int32(n),
            "pixel_pos_ids": np.zeros((n, 2), np.int32)}


def test_weight_push_carries_the_tower(weights):
    """The streamed update over HTTP carries the whole ``vision`` subtree, as
    JAX's bucket plan does (it walks every leaf of the tree): after a push
    from a trainer with the frozen tower, the server's bf16 tower equals the
    trainer's cast to bf16, and the commit refuses an update without it."""
    from areal_tpu_torch.api.config import InferenceEngineConfig
    from areal_tpu_torch.api.io_struct import WeightUpdateMeta
    from areal_tpu_torch.inference.client import RemoteTorchEngine
    from areal_tpu_torch.inference.server import ServerThread

    teng = tte.TorchTrainEngine(PPOActorConfig(), model_config=port_mcfg(JMCFG), device="cpu")
    teng.initialize(seed=4)
    cfg = ServerConfig(**SERVER_KW, host="127.0.0.1", port=0, dtype="bfloat16")
    served = port_model(weights, port_mcfg(JMCFG, dtype="bfloat16"))
    srv = ServerThread(cfg, engine=tde.DecodeEngine(cfg, params=served, device="cpu"))
    srv.start()
    client = RemoteTorchEngine(InferenceEngineConfig(weight_chunk_mb=1, request_timeout=120), addresses=[srv.address])
    try:
        client.initialize()
        state = teng._export_params()
        assert any(n.startswith("vision.layers.") for n in state)
        client.update_weights(WeightUpdateMeta(type="mem"), params=state)
        tower = dict(srv.engine.model.vision.named_parameters())
        for n, p in teng.model.vision.named_parameters():
            assert torch.equal(tower[n], p.detach().to(torch.bfloat16)), n
        with pytest.raises(RuntimeError):
            client.update_weights(WeightUpdateMeta(type="mem"),
                                  params={n: t for n, t in state.items() if not n.startswith("vision.")})
    finally:
        client.destroy()
        srv.stop()
