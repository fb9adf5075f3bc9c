"""Disk weight updates over HTTP (the twin of ``tests/test_disk_weight_update.py``):
the trainer exports HF safetensors, the server reloads them through
``/update_weights_from_disk`` inside the client's hold fence, the versions
advance, and the served weights are the trainer's. Also the whole-model
``/update_weights_from_tensors``, and the JAX server and the port's server
serving the same greedy tokens from one directory.

Bit-for-bit: a bf16 server's weights after a disk update equal the
trainer's f32 master weights rounded to bf16 once, which is what the
streamed ("mem") update serves too."""

import dataclasses
import io
import json
import os
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api.config import MeshConfig as JMeshConfig
from areal_tpu.api.config import ServerConfig as JServerConfig
from areal_tpu.inference import decode_engine as jde
from areal_tpu.inference.server import ServerThread as JServerThread
from areal_tpu.models import qwen as jq
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu_torch.api.config import InferenceEngineConfig, PPOActorConfig, ServerConfig
from areal_tpu_torch.api.io_struct import (
    FinetuneSpec,
    GenerationHyperparameters,
    ModelRequest,
    SaveLoadMeta,
    WeightUpdateMeta,
)
from areal_tpu_torch.engine.train_engine import TorchTrainEngine
from areal_tpu_torch.inference.client import RemoteTorchEngine
from areal_tpu_torch.inference.decode_engine import DecodeEngine
from areal_tpu_torch.inference.server import ServerThread
from areal_tpu_torch.models import convert

from test_torch_checkpoint import BATCHES, _loss, _wf
from test_torch_decode_engine import _server_kwargs
from test_torch_qwen import jax_params, port_cfg
from test_torch_train_engine import COMMON
from tpu_testing import TINY_QWEN2

CFG = port_cfg(TINY_QWEN2)
BF16 = dataclasses.replace(CFG, dtype="bfloat16")


def _post(addr: str, path: str, body, raw: bool = False) -> tuple[int, dict]:
    data = body if raw else json.dumps(body).encode()
    req = urllib.request.Request(f"http://{addr}{path}", data=data, method="POST",
                                 headers={"Content-Type": "application/octet-stream" if raw else "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _trainer(seed=3):
    eng = TorchTrainEngine(PPOActorConfig(weight_update_mode="disk", **COMMON), model_config=CFG, device="cpu")
    eng.initialize(FinetuneSpec(1, 64, 16))
    eng.model.load_state_dict(convert.from_jax_params(jax_params(TINY_QWEN2, seed=seed), CFG))
    eng.train_batch(BATCHES[0], _loss, _wf)
    eng.train_batch(BATCHES[1], _loss, _wf)  # the first step has LR 0: the second moves the weights
    return eng


def _server(seed=0, dtype_cfg=BF16):
    scfg = ServerConfig(**_server_kwargs(), host="127.0.0.1")
    dec = DecodeEngine(scfg, params=convert.from_jax_params(jax_params(TINY_QWEN2, seed=seed), CFG),
                       model_cfg=dtype_cfg, device="cpu")
    return ServerThread(scfg, engine=dec)


def _served_equals_bf16_of(engine: DecodeEngine, master: dict) -> list[str]:
    served = dict(engine.model.named_parameters())
    return [n for n, p in master.items() if not torch.equal(served[n].detach(), p.detach().to(torch.bfloat16))]


def test_disk_weight_update_roundtrip(tmp_path):
    """The trainer's disk update through ``RemoteTorchEngine``: the export
    lands in ``v<version>`` with its config, the server's version rises
    with the trainer's, the hold fence brackets the reload, and the served
    weights (changed) equal the trainer's bf16 export bit for bit, as a
    memory update's would; the served greedy stream equals that of an
    engine built from the trainer's weights."""
    eng = _trainer()
    srv = _server(seed=0)
    modes = []
    h_pause = srv.server.h_pause

    def h_pause_logged(d):
        status, out = h_pause(d)
        modes.append((d.get("mode"), out.get("fenced")))
        return status, out

    srv.server.h_pause = h_pause_logged
    srv.start()
    client = RemoteTorchEngine(InferenceEngineConfig(), addresses=[srv.address])
    client.initialize()
    mem_srv = _server(seed=0)
    mem_srv.start()
    mem_client = RemoteTorchEngine(InferenceEngineConfig(), addresses=[mem_srv.address])
    mem_client.initialize()
    try:
        meta = WeightUpdateMeta(type="disk", path=str(tmp_path / "wu"), with_version=True)
        eng.connect_engine(client, meta)
        before = {n: p.detach().clone() for n, p in srv.engine.model.named_parameters()}
        v0 = eng.get_version()
        eng.update_weights(meta)
        eng.set_version(v0 + 1)  # the trainer owns the version bump after a push
        assert srv.engine.get_version() == client.get_version() == eng.get_version() == v0 + 1
        assert os.path.exists(tmp_path / "wu" / f"v{v0}" / "config.json")
        assert modes == [("hold", True)]
        master = dict(eng.model.named_parameters())
        assert _served_equals_bf16_of(srv.engine, master) == []
        assert any(not torch.equal(before[n], p.detach()) for n, p in srv.engine.model.named_parameters())
        mem_client.update_weights(WeightUpdateMeta(type="mem"), params=eng._export_params())
        assert all(torch.equal(a.detach(), b.detach()) for a, b in
                   zip(srv.engine.model.parameters(), mem_srv.engine.model.parameters()))
        req = ModelRequest(input_ids=[1, 2, 3, 4], gconfig=GenerationHyperparameters(max_new_tokens=8, greedy=True))
        ref = DecodeEngine(ServerConfig(**_server_kwargs()), params=eng._export_params(), model_cfg=BF16,
                           device="cpu")
        ref.start()
        try:
            want = ref.generate_sync(req, timeout=60).output_tokens
        finally:
            ref.stop()
        got = srv.engine.generate_sync(req, timeout=60)
        assert got.output_tokens == want and got.output_versions == [v0 + 1] * 8
    finally:
        client.destroy()
        mem_client.destroy()
        srv.stop()
        mem_srv.stop()


def test_update_weights_from_disk_route(tmp_path):
    """``/update_weights_from_disk``: ``{path, version}`` in, ``{status,
    version}`` out; a path without a checkpoint fails with the weights and
    version untouched; a body without a path is a 400."""
    eng = _trainer()
    path = str(tmp_path / "ck")
    eng.save(SaveLoadMeta(path=path, weight_format="hf"))
    srv = _server(seed=0)
    srv.start()
    try:
        before = [p.detach().clone() for p in srv.engine.model.parameters()]
        status, out = _post(srv.address, "/update_weights_from_disk", {"path": str(tmp_path / "nowhere"),
                                                                       "version": 5})
        assert status == 500 and "FileNotFoundError" in out["error"]
        assert srv.engine.get_version() == 0
        assert all(torch.equal(a, b.detach()) for a, b in zip(before, srv.engine.model.parameters()))
        assert _post(srv.address, "/update_weights_from_disk", {"version": 5})[0] == 400
        status, out = _post(srv.address, "/update_weights_from_disk", {"path": path, "version": 5})
        assert (status, out) == (200, {"status": "ok", "version": 5})
        assert _served_equals_bf16_of(srv.engine, dict(eng.model.named_parameters())) == []
    finally:
        srv.stop()


def test_update_weights_from_tensors_route():
    """``/update_weights_from_tensors``: an npz of the JAX package's
    stacked paths with ``__version__``; the served weights equal the f32
    values rounded to bf16 once. A body of the port's own names, or no npz
    at all, answers 400."""
    eng = _trainer()
    sd = {n: p.detach() for n, p in eng.model.named_parameters()}
    tree = convert.to_jax_params(sd, CFG)
    flat = {f"layers/{k}": v for k, v in tree.pop("layers").items()}
    flat.update(tree)
    buf = io.BytesIO()
    np.savez(buf, __version__=np.int64(7), **flat)
    port_names = io.BytesIO()
    np.savez(port_names, __version__=np.int64(8), **{n: t.numpy() for n, t in sd.items()})
    srv = _server(seed=0)
    srv.start()
    try:
        status, out = _post(srv.address, "/update_weights_from_tensors", buf.getvalue(), raw=True)
        assert (status, out) == (200, {"status": "ok", "version": 7})
        assert _served_equals_bf16_of(srv.engine, sd) == []
        assert _post(srv.address, "/update_weights_from_tensors", port_names.getvalue(), raw=True)[0] == 400
        assert _post(srv.address, "/update_weights_from_tensors", b"not an npz", raw=True)[0] == 400
        assert srv.engine.get_version() == 7
    finally:
        srv.stop()


def test_jax_and_port_servers_serve_the_same_tokens(tmp_path):
    """The JAX server and the port's server, each told to reload the same
    directory (the port trainer's export) over ``/update_weights_from_disk``,
    serve the same greedy tokens at the same version (f32 serving)."""
    eng = _trainer(seed=4)
    path = str(tmp_path / "v1")
    eng.save(SaveLoadMeta(path=path, weight_format="hf"))
    jcfg = JServerConfig(**_server_kwargs(), host="127.0.0.1", mesh=JMeshConfig(data=1))
    jeng = jde.DecodeEngine(jcfg, params=jq.init_params(jax.random.PRNGKey(0), TINY_QWEN2), model_cfg=TINY_QWEN2,
                            mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    jeng.initialize()
    jsrv = JServerThread(jcfg, jeng)
    jsrv.start()
    tsrv = _server(seed=0, dtype_cfg=CFG)
    tsrv.start()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, CFG.vocab_size, n).tolist() for n in (4, 9, 17)]
    try:
        outs = {}
        for name, addr in (("jax", jsrv.address), ("port", tsrv.address)):
            assert _post(addr, "/update_weights_from_disk", {"path": path, "version": 1}) == (
                200, {"status": "ok", "version": 1})
            outs[name] = [
                _post(addr, "/generate", {"input_ids": p, "sampling_params": {"max_new_tokens": 10, "greedy": True}})[1]
                for p in prompts
            ]
        for j, t in zip(outs["jax"], outs["port"]):
            assert t["output_tokens"] == j["output_tokens"]
            assert t["output_versions"] == j["output_versions"] == [1] * 10
    finally:
        jsrv.stop()
        tsrv.stop()
