"""The trainer's durable state against the JAX package on the CPU: HF
safetensors export and load in both directions, engines built from a
checkpoint, the recover format's resume (bit for bit), offload / onload,
and the disk weight update into an in-process engine.

Tolerances: checkpoints cross exactly (f32 leaves, the same bits); engines
built from one checkpoint are held at the twins' tolerances of
``test_torch_train_engine.py`` (logprobs) and to equal greedy tokens; a
resumed run equals an uninterrupted one bit for bit on the CPU (the same
arithmetic in the same order), and stays within the trainer twin's
tolerance of JAX's uninterrupted run."""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.config import MeshConfig as JMeshConfig
from areal_tpu.api.config import OptimizerConfig as JOptimizerConfig
from areal_tpu.api.config import PPOActorConfig as JPPOActorConfig
from areal_tpu.api.config import ServerConfig as JServerConfig
from areal_tpu.api.io_struct import FinetuneSpec as JFinetuneSpec
from areal_tpu.api.io_struct import GenerationHyperparameters as JGen
from areal_tpu.api.io_struct import ModelRequest as JRequest
from areal_tpu.engine import train_engine as jte
from areal_tpu.inference import decode_engine as jde
from areal_tpu.models import hf as jhf
from areal_tpu.models import qwen as jq
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu.utils import data as jdata
from areal_tpu_torch.api.config import OptimizerConfig, PPOActorConfig, ServerConfig, TrainEngineConfig
from areal_tpu_torch.api.io_struct import (
    FinetuneSpec,
    GenerationHyperparameters,
    ModelRequest,
    SaveLoadMeta,
    WeightUpdateMeta,
)
from areal_tpu_torch.engine import train_engine as tte
from areal_tpu_torch.inference.decode_engine import DecodeEngine
from areal_tpu_torch.models import convert
from areal_tpu_torch.models import hf as thf
from areal_tpu_torch.models import qwen as tq
from areal_tpu_torch.utils import safetensors_io

from test_torch_decode_engine import PROMPT_LENS, _run_all, _server_kwargs
from test_torch_moe import MOE_CFG
from test_torch_qwen import jax_params, port_cfg
from test_torch_train_engine import COMMON, LOGP_TOL, _trajs
from tpu_testing import TINY_QWEN2, TINY_QWEN3

CONFIGS = {
    "qwen2": dataclasses.replace(TINY_QWEN2, tie_word_embeddings=False),  # q/k/v biases, own head
    "qwen3": TINY_QWEN3,  # qk_norm
    "tied": TINY_QWEN2,  # tied embeddings
    "moe": MOE_CFG,  # qwen3_moe: one HF tensor per (layer, expert)
}
# resume twins: Adam's eps at 1e-5 keeps near-zero gradients from taking
# sign-like steps, so every element is held to f32 noise against JAX
# (tests/test_torch_ppo_trainer_loop.py)
LR, ADAM_EPS = 1e-3, 1e-5
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


def _header(path: str) -> dict:
    f = safetensors_io.SafetensorsFile(os.path.join(path, "model.safetensors"))
    return {k: f.info(k) for k in f.keys()}


def _exports(tmp_path, name, seed=1):
    """The same weights exported by both packages: (jcfg, cfg, JAX params,
    port state dict, port dir, JAX dir)."""
    jcfg = CONFIGS[name]
    cfg = port_cfg(jcfg)
    jp = jax_params(jcfg, seed=seed)
    sd = convert.from_jax_params(jp, cfg)
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    thf.save_params_to_hf(sd, cfg, tdir)
    jhf.save_params_to_hf(jp, jcfg, jdir)
    return jcfg, cfg, jp, sd, tdir, jdir


# ---------------------------------------------------------------------------
# HF safetensors in both directions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_export_read_by_jax(tmp_path, name):
    """The port's export, read by JAX's ``load_params_from_hf``, equals
    ``convert.to_jax_params`` of the port's weights exactly."""
    jcfg, cfg, _, sd, tdir, _ = _exports(tmp_path, name)
    got, _ = jhf.load_params_from_hf(tdir, jcfg)
    want = convert.to_jax_params(sd, cfg)
    jax.tree.map(np.testing.assert_array_equal, want, jax.tree.map(np.asarray, got))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_jax_export_read_by_port(tmp_path, name):
    """JAX's export, read by the port, equals ``convert.from_jax_params``
    exactly; the two exports' headers hold the same names, shapes and
    dtypes (F32)."""
    _, cfg, _, sd, tdir, jdir = _exports(tmp_path, name)
    model, got_cfg = thf.load_params_from_hf(jdir, device="cpu", dtype="float32")
    assert got_cfg == cfg
    got = dict(model.named_parameters())
    assert got.keys() == sd.keys()
    for n, t in sd.items():
        assert torch.equal(got[n].detach(), t), n
    assert _header(tdir) == _header(jdir)
    assert {d for d, _ in _header(tdir).values()} == {torch.float32}
    if cfg.num_experts:
        assert "model.layers.1.mlp.experts.7.down_proj.weight" in _header(tdir)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_hf_config_written_and_read_alike(tmp_path, name):
    """``write_hf_config`` writes the JAX function's JSON, and
    ``ModelConfig.from_hf_path`` gives the JAX config's fields."""
    jcfg, cfg, *_ = _exports(tmp_path, name)
    with open(tmp_path / "port" / "config.json") as a, open(tmp_path / "jax" / "config.json") as b:
        assert json.load(a) == json.load(b)
    jgot = jq.ModelConfig.from_hf_path(str(tmp_path / "port"))
    tgot = tq.ModelConfig.from_hf_path(str(tmp_path / "jax"))
    assert tgot == port_cfg(jgot)
    assert dataclasses.replace(tgot, dtype=cfg.dtype) == cfg  # config.json holds no dtype


def test_base_model_files_copied(tmp_path):
    """With a base model directory the export copies its config and
    tokenizer files, as the JAX export does, and writes no config of its
    own."""
    _, cfg, _, sd, _, jdir = _exports(tmp_path, "qwen2")
    base = tmp_path / "base"
    shutil.copytree(jdir, base)
    (base / "tokenizer.json").write_text('{"model": "tiny"}')
    (base / "merges.txt").write_text("a b\n")
    thf.save_params_to_hf(sd, cfg, str(tmp_path / "out"), base_model_path=str(base))
    jhf.save_params_to_hf(jax_params(CONFIGS["qwen2"], seed=1), CONFIGS["qwen2"], str(tmp_path / "jout"),
                          base_model_path=str(base))
    for fname in ("config.json", "tokenizer.json", "merges.txt"):
        assert (tmp_path / "out" / fname).read_bytes() == (tmp_path / "jout" / fname).read_bytes() == \
            (base / fname).read_bytes()


def test_untied_checkpoint_without_lm_head(tmp_path):
    """An untied model whose checkpoint ships no ``lm_head.weight`` takes
    ``embed_tokens`` as its head in both loaders."""
    jcfg, cfg, _, sd, tdir, _ = _exports(tmp_path, "qwen2")
    f = safetensors_io.SafetensorsFile(os.path.join(tdir, "model.safetensors"))
    kept = {k: f.get(k).clone() for k in f.keys() if k != "lm_head.weight"}
    f.close()
    safetensors_io.save_tensors(kept, os.path.join(tdir, "model.safetensors"))
    model, _ = thf.load_params_from_hf(tdir, device="cpu", dtype="float32")
    jgot, _ = jhf.load_params_from_hf(tdir, jcfg)
    assert torch.equal(model.lm_head.detach(), sd["embed"])
    np.testing.assert_array_equal(np.asarray(jgot["lm_head"]), sd["embed"].numpy())


def test_bf16_file_read_by_both(tmp_path):
    """A BF16 checkpoint written by the port's writer (HF names, the tiny
    model's weights rounded to bf16) loads in both packages to the same
    values: JAX's loader (safetensors' numpy reader, which takes bfloat16
    once jax has registered the type) and the port's; the port's reader
    also equals the safetensors package's torch reader and a decode of the
    raw bits (bf16 is the high half of an f32)."""
    jcfg = CONFIGS["qwen3"]
    cfg = port_cfg(jcfg)
    sd = convert.from_jax_params(jax_params(jcfg, seed=2), cfg)
    path = str(tmp_path / "bf16")
    tensors = {}
    for key, (hf_name, transpose) in tq.hf_name_map(cfg).items():
        t = sd[key]
        tensors[hf_name] = (t.t() if transpose else t).to(torch.bfloat16).contiguous()
    safetensors_io.save_tensors(tensors, os.path.join(path, "model.safetensors"))
    thf.write_hf_config(cfg, path)
    model, _ = thf.load_params_from_hf(path, device="cpu", dtype="float32")
    jgot, _ = jhf.load_params_from_hf(path, jcfg)
    want = convert.to_jax_params({k: v.to(torch.bfloat16) for k, v in sd.items()}, cfg)
    jax.tree.map(np.testing.assert_array_equal, want, jax.tree.map(np.asarray, jgot))
    jax.tree.map(np.testing.assert_array_equal, want, convert.to_jax_params(model.state_dict(), cfg))

    from safetensors.torch import load_file

    mine = safetensors_io.SafetensorsFile(os.path.join(path, "model.safetensors"))
    theirs = load_file(os.path.join(path, "model.safetensors"))
    assert {d for d, _ in (mine.info(k) for k in mine.keys())} == {torch.bfloat16}
    for k, t in tensors.items():
        assert torch.equal(mine.get(k), t) and torch.equal(theirs[k], t), k
    name = "model.embed_tokens.weight"
    raw = np.fromfile(os.path.join(path, "model.safetensors"), dtype=np.uint8)
    start = mine.data_start + mine.entries[name][2][0]
    n = tensors[name].numel()
    bits = raw[start : start + 2 * n].view(np.uint16).astype(np.uint32) << 16
    np.testing.assert_array_equal(bits.view(np.float32).reshape(tensors[name].shape),
                                  mine.get(name).float().numpy())


def test_safetensors_reader_rejects_bad_files(tmp_path):
    path = tmp_path / "x.safetensors"
    safetensors_io.save_tensors({"w": torch.arange(12, dtype=torch.float32)}, str(path))
    raw = path.read_bytes()
    path.write_bytes(raw[:-8])  # truncated data
    with pytest.raises(ValueError, match="do not fit"):
        safetensors_io.SafetensorsFile(str(path))
    path.write_bytes(raw[:5])
    with pytest.raises(ValueError, match="too short"):
        safetensors_io.SafetensorsFile(str(path))
    with pytest.raises(ValueError, match="declared"):
        safetensors_io.save_file([("w", torch.float32, [3], lambda: torch.zeros(4))], str(tmp_path / "y"))
    assert not os.path.exists(tmp_path / "y") and not os.listdir(tmp_path) == []


def test_checkpoint_that_does_not_fit_changes_nothing(tmp_path):
    """Loading a checkpoint of another shape into a model raises before
    the first copy; a vision config parses into the tower JAX parses."""
    _, cfg, _, sd, tdir, _ = _exports(tmp_path, "qwen3")
    other = tq.init_params(dataclasses.replace(cfg, hidden_size=32), torch.Generator().manual_seed(0), device="cpu")
    before = {n: p.detach().clone() for n, p in other.named_parameters()}
    with pytest.raises(ValueError, match="shape"):
        thf.load_params_from_hf(tdir, model=other)
    assert all(torch.equal(p.detach(), before[n]) for n, p in other.named_parameters())
    with open(os.path.join(tdir, "config.json")) as f:
        d = json.load(f)
    vlm = tq.ModelConfig.from_hf_dict({**d, "vision_config": {}})
    assert dataclasses.asdict(vlm.vision) == dataclasses.asdict(jq.ModelConfig.from_hf_dict(
        {**d, "vision_config": {}}).vision)


# ---------------------------------------------------------------------------
# engines built from a checkpoint the JAX package wrote
# ---------------------------------------------------------------------------


def test_train_engine_from_jax_checkpoint(tmp_path):
    """``TorchTrainEngine(path=...)`` and ``JaxTrainEngine(path=...)`` built
    from one directory give the same logprobs (the twin tolerance)."""
    _, cfg, _, sd, _, jdir = _exports(tmp_path, "qwen2", seed=4)
    jcfg = JPPOActorConfig(path=jdir, mesh=JMeshConfig(data=1), **COMMON)
    jeng = jte.JaxTrainEngine(jcfg)
    jeng.initialize(JFinetuneSpec(1, 128, 16), mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    teng = tte.TorchTrainEngine(PPOActorConfig(path=jdir, **COMMON), device="cpu")
    teng.initialize(FinetuneSpec(1, 128, 16))
    assert dataclasses.replace(teng._model_config, dtype=cfg.dtype) == cfg
    assert all(torch.equal(p.detach(), sd[n]) for n, p in teng.model.named_parameters())
    batch = jdata.pad_sequences_to_tensors(_trajs(6, seed=2))
    np.testing.assert_allclose(teng.forward_batch(batch), jeng.forward_batch(batch), **LOGP_TOL)
    # init_from_scratch ignores the path, as in JAX
    scratch = tte.TorchTrainEngine(PPOActorConfig(path=jdir, init_from_scratch=True, **COMMON), device="cpu")
    scratch.initialize(FinetuneSpec(1, 128, 16))
    assert not torch.equal(scratch.model.embed.detach(), sd["embed"])


def test_decode_engine_from_jax_checkpoint(tmp_path):
    """``DecodeEngine(ServerConfig(model_path=...))`` of both packages serve
    the same greedy tokens from one directory (f32 serving)."""
    _, cfg, _, sd, _, jdir = _exports(tmp_path, "qwen3", seed=6)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    jcfg = JServerConfig(**_server_kwargs(), model_path=jdir, dtype="float32", mesh=JMeshConfig(data=1))
    jeng = jde.DecodeEngine(jcfg, mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    jeng.initialize()
    jeng.start()
    try:
        want = _run_all(jeng, [JRequest(input_ids=p, gconfig=JGen(max_new_tokens=12, greedy=True)) for p in prompts])
    finally:
        jeng.stop()
    eng = DecodeEngine(ServerConfig(**_server_kwargs(), model_path=jdir, dtype="float32"), device="cpu")
    eng.start()
    try:
        assert eng.model_cfg == dataclasses.replace(cfg, remat=False)
        assert all(torch.equal(p.detach(), sd[n]) for n, p in eng.model.named_parameters())
        got = _run_all(eng, [ModelRequest(input_ids=p, gconfig=GenerationHyperparameters(max_new_tokens=12,
                                                                                         greedy=True))
                             for p in prompts])
    finally:
        eng.stop()
    assert [g.output_tokens for g in got] == [w.output_tokens for w in want]
    with pytest.raises(ValueError, match="model_path"):
        DecodeEngine(ServerConfig(**_server_kwargs()), device="cpu").initialize()


# ---------------------------------------------------------------------------
# the recover format: resume, asynchronous snapshots, offload
# ---------------------------------------------------------------------------


def _port_engine(params, cfg):
    eng = tte.TorchTrainEngine(
        PPOActorConfig(optimizer=OptimizerConfig(lr=LR, eps=ADAM_EPS, lr_scheduler_type="cosine"), **COMMON),
        model_config=cfg, device="cpu",
    )
    eng.initialize(FinetuneSpec(1, 64, 16))
    eng.model.load_state_dict(convert.from_jax_params(params, cfg))
    return eng


def _jax_engine(params):
    jcfg = JPPOActorConfig(init_from_scratch=True, mesh=JMeshConfig(data=1),
                           optimizer=JOptimizerConfig(lr=LR, eps=ADAM_EPS, lr_scheduler_type="cosine"), **COMMON)
    eng = jte.JaxTrainEngine(jcfg, model_config=TINY_QWEN2)
    eng.initialize(JFinetuneSpec(1, 64, 16), mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    eng.params = jax.tree.map(lambda old, new: jax.device_put(jnp.asarray(new), old.sharding), eng.params, params)
    return eng


def _loss(outputs, b):
    lm = (b["label_valid"] & (b["loss_mask"] > 0)).float()
    return -(outputs["logprobs"] * lm).sum() / lm.sum().clamp(min=1), {}


def _jloss(outputs, b):
    lm = (b["label_valid"] & (b["loss_mask"] > 0)).astype(jnp.float32)
    return -(outputs["logprobs"] * lm).sum() / jnp.maximum(lm.sum(), 1), {}


def _wf(d):
    return float((np.asarray(d["loss_mask"]) > 0).sum())


def _state(eng) -> dict:
    out = {f"p/{n}": p.detach().clone() for n, p in eng.model.named_parameters()}
    for i, (m, v) in enumerate(zip(eng._opt.mu, eng._opt.nu)):
        out[f"mu/{i}"], out[f"nu/{i}"] = m.clone(), v.clone()
    out["count"] = torch.tensor(eng._opt.count)
    return out


def _assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


BATCHES = [jdata.pad_sequences_to_tensors(_trajs(8, seed=40 + i)) for i in range(4)]


@pytest.mark.parametrize("split", ["sync", "async"])
def test_resume_equals_uninterrupted_bitwise(tmp_path, split):
    """k = 2 steps, a recover-format save (``save``, or the snapshot /
    write split of ``Saver.save_async``), a fresh engine ``load``s it, m = 2
    more steps: parameters, moments and step count equal those of 4
    uninterrupted steps bit for bit (cosine LR: the schedule goes on from
    the restored count). The resumed run stays within the trainer twin's
    tolerance of JAX's 4 uninterrupted steps."""
    cfg = port_cfg(TINY_QWEN2)
    params = jax_params(TINY_QWEN2, seed=2)
    straight = _port_engine(params, cfg)
    for b in BATCHES:
        straight.train_batch(b, _loss, _wf)
    first = _port_engine(params, cfg)
    for b in BATCHES[:2]:
        first.train_batch(b, _loss, _wf)
    at_save = _state(first)
    path = str(tmp_path / "ck")
    if split == "sync":
        first.save(SaveLoadMeta(path=path, weight_format="state", with_optim=True))
    else:
        snap = first.snapshot_for_save(with_optim=True)
        first.train_batch(BATCHES[2], _loss, _wf)  # the state moves on; the snapshot does not
        first.write_snapshot(snap, path)
    assert sorted(os.listdir(os.path.join(path, "state"))) == [
        "manifest.json", "mu.safetensors", "nu.safetensors", "params.safetensors"]
    resumed = _port_engine(jax_params(TINY_QWEN2, seed=3), cfg)  # other weights, fresh moments
    resumed.load(SaveLoadMeta(path=path, weight_format="state", with_optim=True))
    _assert_bitwise(_state(resumed), at_save)
    stats = [resumed.train_batch(b, _loss, _wf) for b in BATCHES[2:]]
    _assert_bitwise(_state(resumed), _state(straight))

    jeng = _jax_engine(params)
    jstats = [jeng.train_batch(b, _jloss, _wf) for b in BATCHES]
    for got, want in zip(stats, jstats[2:]):
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-4)
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jeng.params))
    got = dict(jax.tree_util.tree_leaves_with_path(convert.to_jax_params(resumed.model.state_dict(), cfg)))
    for key, w in want:
        np.testing.assert_allclose(got[key], w, **PARAM_TOL, err_msg=str(key))


def test_state_format_checks(tmp_path):
    """A state directory without its manifest (a write cut short) does not
    load; nor does one of another model; "orbax" is refused naming the
    port's format; a load of params only leaves the moments."""
    cfg = port_cfg(TINY_QWEN2)
    eng = _port_engine(jax_params(TINY_QWEN2, seed=2), cfg)
    eng.train_batch(BATCHES[0], _loss, _wf)
    path = str(tmp_path / "ck")
    eng.save(SaveLoadMeta(path=path, weight_format="state", with_optim=True))
    other = tte.TorchTrainEngine(PPOActorConfig(**COMMON), model_config=dataclasses.replace(cfg, num_layers=1),
                                 device="cpu")
    other.initialize()
    with pytest.raises(ValueError, match="names differ"):
        other.load(SaveLoadMeta(path=path, weight_format="state", with_optim=True))
    with pytest.raises(ValueError, match="'state'"):
        eng.load(SaveLoadMeta(path=path, weight_format="orbax"))
    fresh = _port_engine(jax_params(TINY_QWEN2, seed=3), cfg)
    fresh.load(SaveLoadMeta(path=path, weight_format="state", with_optim=False))
    assert fresh._opt.count == 0 and not any(m.any() for m in fresh._opt.mu)
    assert all(torch.equal(a, b) for a, b in zip(fresh.model.parameters(), eng.model.parameters()))
    os.unlink(os.path.join(path, "state", "manifest.json"))
    with pytest.raises(FileNotFoundError):
        fresh.load(SaveLoadMeta(path=path, weight_format="state", with_optim=True))


def test_hf_save_load_through_the_engine(tmp_path):
    """``save`` / ``load`` in the HF format: the master weights go out as
    F32 and come back exactly; JAX reads them too."""
    cfg = port_cfg(TINY_QWEN2)
    eng = _port_engine(jax_params(TINY_QWEN2, seed=2), cfg)
    eng.train_batch(BATCHES[0], _loss, _wf)
    eng.train_batch(BATCHES[1], _loss, _wf)
    path = str(tmp_path / "hf")
    eng.save(SaveLoadMeta(path=path, weight_format="hf"))
    other = _port_engine(jax_params(TINY_QWEN2, seed=3), cfg)
    other.load(SaveLoadMeta(path=path, weight_format="hf"))
    assert all(torch.equal(a, b) for a, b in zip(other.model.parameters(), eng.model.parameters()))
    got, _ = jhf.load_params_from_hf(path, TINY_QWEN2)
    jax.tree.map(np.testing.assert_array_equal, convert.to_jax_params(eng.model.state_dict(), cfg),
                 jax.tree.map(np.asarray, got))


def test_offload_onload_bitwise():
    """``offload`` then ``onload`` brings parameters, moments and the step
    count back bit for bit, and the next step equals that of an engine
    that never offloaded (on the CPU the tensors stay where they are)."""
    cfg = port_cfg(TINY_QWEN2)
    params = jax_params(TINY_QWEN2, seed=2)
    a, b = _port_engine(params, cfg), _port_engine(params, cfg)
    for e in (a, b):
        e.train_batch(BATCHES[0], _loss, _wf)
        e.train_batch(BATCHES[1], _loss, _wf)
    before = _state(a)
    a.offload()
    assert a._offload_mode == "none"
    a.offload()  # idempotent
    a.onload()
    assert a._offload_mode is None
    _assert_bitwise(_state(a), before)
    a.train_batch(BATCHES[2], _loss, _wf)
    b.train_batch(BATCHES[2], _loss, _wf)
    _assert_bitwise(_state(a), _state(b))


def test_disk_update_into_decode_engine(tmp_path):
    """``update_weights`` of type "disk" into an in-process bf16 engine:
    the export lands under ``v<version>`` and the served weights equal the
    memory path's (both round the f32 master weights to bf16 once) bit for
    bit; the version rises and the flight ring records a disk commit."""
    cfg = port_cfg(TINY_QWEN2)
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    teng = _port_engine(jax_params(TINY_QWEN2, seed=2), cfg)
    teng.train_batch(BATCHES[0], _loss, _wf)
    teng.train_batch(BATCHES[1], _loss, _wf)
    scfg = ServerConfig(**_server_kwargs())
    engines = {}
    for kind in ("disk", "mem"):
        dec = DecodeEngine(scfg, params=convert.from_jax_params(jax_params(TINY_QWEN2, seed=5), cfg), model_cfg=bcfg,
                           device="cpu")
        dec.start()
        teng.connect_engine(dec, WeightUpdateMeta(type=kind, path=str(tmp_path / "wu"), with_version=True))
        teng.set_version(3)
        teng.update_weights()
        engines[kind] = dec
    try:
        assert os.path.exists(tmp_path / "wu" / "v3" / "config.json")
        served = {k: dict(e.model.named_parameters()) for k, e in engines.items()}
        for n, p in teng.model.named_parameters():
            want = p.detach().to(torch.bfloat16)
            assert torch.equal(served["disk"][n].detach(), want) and torch.equal(served["mem"][n].detach(), want), n
        assert engines["disk"].get_version() == 1
        commits = [e["data"] for e in engines["disk"].flight.snapshot()["events"] if e["kind"] == "weight_commit"]
        assert {"update_kind": "disk", "version": 1} in [{k: c[k] for k in ("update_kind", "version")}
                                                         for c in commits]
        prompt = ModelRequest(input_ids=[3, 1, 4, 1, 5], gconfig=GenerationHyperparameters(max_new_tokens=8,
                                                                                            greedy=True))
        assert engines["disk"].generate_sync(prompt, timeout=60).output_tokens == \
            engines["mem"].generate_sync(prompt, timeout=60).output_tokens
        # a directory that does not hold a checkpoint fails that update only
        with pytest.raises(FileNotFoundError):
            engines["disk"].update_weights_from_disk(str(tmp_path / "nowhere"), version=9)
        assert engines["disk"].get_version() == 1
    finally:
        for e in engines.values():
            e.stop()


def test_train_engine_config_from_path_only(tmp_path):
    """With no ``model_config`` the engine reads the checkpoint's
    ``config.json``; with neither it raises."""
    _, cfg, _, sd, tdir, _ = _exports(tmp_path, "moe", seed=8)
    eng = tte.TorchTrainEngine(TrainEngineConfig(path=tdir, dtype="float32"), device="cpu")
    eng.initialize()
    assert eng.model_cfg.num_experts == cfg.num_experts
    assert all(torch.equal(p.detach(), sd[n]) for n, p in eng.model.named_parameters())
    with pytest.raises(ValueError, match="path or model_config"):
        tte.TorchTrainEngine(TrainEngineConfig(), device="cpu").initialize()
