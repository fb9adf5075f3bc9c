"""The port's vision-language model pieces against the JAX package on the
CPU, on the same seeded numpy inputs: ``pad_patch_bucket`` and
``grid_pos_ids`` (exact), the Qwen2-VL tower masked and unmasked at grid
positions, single and batched, in f32 and bf16, the decoder's forward and
prefill with image embeddings, ``from_hf_dict`` on Qwen2-VL-2B's config,
the ``visual.*`` load from a safetensors file, the bridge, ragged pixel
batching and the client's /generate body for an image request.

Tolerances: f32 paths agree to 2e-5 (the port's twin rule, summation order
only). bf16 towers to 2^-5 of the largest output: JAX on the CPU keeps
bf16 elementwise chains in f32 between ops (XLA's excess precision), so
the two round at different points, a few bf16 steps apart."""

import asyncio
import base64
import dataclasses
import io
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.config import InferenceEngineConfig as JInferenceEngineConfig
from areal_tpu.api.io_struct import GenerationHyperparameters as JGen
from areal_tpu.api.io_struct import ModelRequest as JModelRequest
from areal_tpu.inference.client import RemoteJaxEngine
from areal_tpu.models import hf as jhf
from areal_tpu.models import qwen as jq
from areal_tpu.models import vision as jv
from areal_tpu.utils import data as jdata
from areal_tpu_torch.api.config import InferenceEngineConfig
from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest
from areal_tpu_torch.inference import server as tserver
from areal_tpu_torch.inference.client import RemoteTorchEngine
from areal_tpu_torch.models import convert
from areal_tpu_torch.models import hf as thf
from areal_tpu_torch.models import qwen as tq
from areal_tpu_torch.models import vision as tv
from areal_tpu_torch.utils import data as tdata
from areal_tpu_torch.utils.safetensors_io import save_tensors

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_SHARE = 2**-5  # of the largest |output|

JVCFG = jv.VisionConfig(patch_dim=48, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
                        out_hidden_size=64, spatial_merge=2)
IMAGE_TOKEN = 9
JMCFG = jq.ModelConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
                       num_kv_heads=2, dtype="float32", image_token_id=IMAGE_TOKEN, vision=JVCFG)
GRID = np.array([[1, 4, 6]])  # 24 patches -> 6 embeddings


def port_vcfg(jvcfg) -> tv.VisionConfig:
    return tv.VisionConfig(**dataclasses.asdict(jvcfg))


def port_mcfg(jcfg, **over) -> tq.ModelConfig:
    names = {f.name for f in dataclasses.fields(tq.ModelConfig)}
    kw = {k: v for k, v in jcfg.__dict__.items() if k in names}
    kw["vision"] = port_vcfg(jcfg.vision) if jcfg.vision is not None else None
    return tq.ModelConfig(**{**kw, **over})


def jax_vlm_params(jcfg=JMCFG, seed=0) -> dict:
    """JAX init (numpy leaves) with random norms and biases in the tower,
    so every leaf's place is tested."""
    p = jax.tree.map(np.asarray, jq.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 7)
    v = p["vision"]
    for tree in (v, v["layers"]):
        for k, a in list(tree.items()):
            if isinstance(a, dict) or k in tv._MATRICES:
                continue
            tree[k] = (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    return p


def port_model(params: dict, cfg: tq.ModelConfig) -> tq.QwenModel:
    model = tq.QwenModel(cfg, device="cpu")
    model.load_state_dict(convert.from_jax_params(params, cfg))
    return model


def _patches(n: int, seed: int = 0, pd: int = 48) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, pd)).astype(np.float32)


@pytest.mark.parametrize("p_raw", [1, 24, 255, 256, 257, 748, 1000])
def test_pad_patch_bucket_matches_jax(p_raw):
    for merge2 in (1, 4, 9):
        assert tv.pad_patch_bucket(p_raw, merge2) == jv.pad_patch_bucket(p_raw, merge2)


@pytest.mark.parametrize("grid", [[[1, 4, 6]], [[2, 2, 4], [1, 6, 2]], [[1, 22, 34]]])
def test_grid_pos_ids_match_jax(grid):
    got = tv.grid_pos_ids(grid, 2)
    np.testing.assert_array_equal(got, jv.grid_pos_ids(grid, 2))
    assert got.dtype == np.int32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_tower_matches_jax(dtype, masked):
    """One image at its grid positions; masked: padded to 32 patches with
    garbage rows under the patch mask."""
    p = jax_vlm_params()["vision"]
    cfg = port_mcfg(JMCFG, dtype=dtype)
    tower = port_model(jax_vlm_params(), cfg).vision
    jp = jax.tree.map(lambda a: jnp.asarray(a, cfg.dtype), p)
    px, pos = _patches(24), tv.grid_pos_ids(GRID, 2)
    mask = None
    if masked:
        px = np.concatenate([px, np.full((8, 48), 123.0, np.float32)])
        pos = np.pad(pos, ((0, 8), (0, 0)))
        mask = np.arange(32) < 24
    want = np.asarray(jv.vision_forward(jp, JVCFG, jnp.asarray(px), None if mask is None else jnp.asarray(mask),
                                        jnp.asarray(pos)).astype(jnp.float32))
    got = tv.vision_forward(tower, cfg.vision, torch.from_numpy(px),
                            None if mask is None else torch.from_numpy(mask), torch.from_numpy(pos)).float().numpy()
    assert got.shape == want.shape == (px.shape[0] // 4, 64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_SHARE * np.abs(want).max()
    if masked:  # the valid embeddings do not see the padding
        clean = tv.vision_forward(tower, cfg.vision, torch.from_numpy(px[:24]), None,
                                  torch.from_numpy(pos[:24])).float().numpy()
        np.testing.assert_allclose(got[:6], clean, **(F32_TOL if dtype == "float32" else dict(atol=1e-2)))


def test_tower_batch_matches_jax():
    """``vision_forward_batch`` against JAX's vmap: rows of 24 and 12 valid
    patches padded to 32; a row of count 0 is left zero (JAX computes a
    fully masked row that no embedding reads)."""
    p = jax_vlm_params()["vision"]
    cfg = port_mcfg(JMCFG)
    tower = port_model(jax_vlm_params(), cfg).vision
    px = np.stack([_patches(32, s) for s in range(3)])
    counts = np.array([24, 12, 0], np.int32)
    grids = ([[1, 4, 6]], [[1, 2, 6]], [[1, 4, 8]])  # 24, 12 and 32 patches
    pos = np.stack([np.pad(tv.grid_pos_ids(g, 2), ((0, 32 - int(np.prod(g))), (0, 0))) for g in grids])
    want = np.asarray(jv.vision_forward_batch(p, JVCFG, jnp.asarray(px), jnp.asarray(counts), jnp.asarray(pos)))
    got = tv.vision_forward_batch(tower, cfg.vision, torch.from_numpy(px), torch.from_numpy(counts),
                                  torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got[:2], want[:2], **F32_TOL)
    assert not got[2].any()
    # each row is the single-image forward under its mask
    one = tv.vision_forward(tower, cfg.vision, torch.from_numpy(px[1]), torch.arange(32) < 12,
                            torch.from_numpy(pos[1])).numpy()
    np.testing.assert_array_equal(got[1], one)


def _vlm_inputs(seed=0, G=2, L=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 128, (G, L)).astype(np.int32)
    ids[:, 2:5] = IMAGE_TOKEN
    seg = np.ones((G, L), np.int32)
    seg[1, 12:] = 0
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (G, L)).copy()
    emb = rng.standard_normal((G, L, 64)).astype(np.float32)
    return ids, seg, pos, emb


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_forward_with_image_embeds_matches_jax(attn_impl):
    """The training forward: the image-pad positions take the embeddings,
    others keep the token embedding (the embeddings there are ignored)."""
    params = jax_vlm_params()
    ids, seg, pos, emb = _vlm_inputs()
    jcfg = dataclasses.replace(JMCFG, remat=False)
    want = np.asarray(jq.forward(params, jcfg, jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(pos),
                                 image_embeds=jnp.asarray(emb)))
    cfg = port_mcfg(JMCFG, attn_impl=attn_impl, remat=False)
    model = port_model(params, cfg)
    got = tq.forward(model, torch.from_numpy(ids), torch.from_numpy(seg), torch.from_numpy(pos),
                     image_embeds=torch.from_numpy(emb)).numpy()
    valid = seg > 0
    np.testing.assert_allclose(got[valid], want[valid], **F32_TOL)
    plain = tq.forward(model, torch.from_numpy(ids), torch.from_numpy(seg), torch.from_numpy(pos)).numpy()
    assert np.allclose(got[:, :2], plain[:, :2], **F32_TOL) and not np.allclose(got[:, 2:], plain[:, 2:])


def test_forward_prefill_with_image_embeds_matches_jax():
    params = jax_vlm_params()
    ids, seg, pos, emb = _vlm_inputs(seed=1)
    want_h, want_k, _ = jq.forward_prefill(params, JMCFG, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(seg),
                                           image_embeds=jnp.asarray(emb))
    model = port_model(params, port_mcfg(JMCFG))
    h, k, _ = tq.forward_prefill(model, torch.from_numpy(ids), torch.from_numpy(pos), torch.from_numpy(seg),
                                 image_embeds=torch.from_numpy(emb))
    valid = seg > 0
    np.testing.assert_allclose(h.numpy()[valid], np.asarray(want_h)[valid], **F32_TOL)
    np.testing.assert_allclose(k.numpy()[:, valid], np.asarray(want_k)[:, valid], **F32_TOL)


# huggingface.co/Qwen/Qwen2-VL-2B-Instruct config.json (the fields the
# parser reads, and the rest as published)
QWEN2_VL_2B = {
    "architectures": ["Qwen2VLForConditionalGeneration"],
    "attention_dropout": 0.0,
    "bos_token_id": 151643,
    "eos_token_id": 151645,
    "vision_start_token_id": 151652,
    "vision_end_token_id": 151653,
    "vision_token_id": 151654,
    "image_token_id": 151655,
    "video_token_id": 151656,
    "hidden_act": "silu",
    "hidden_size": 1536,
    "initializer_range": 0.02,
    "intermediate_size": 8960,
    "max_position_embeddings": 32768,
    "max_window_layers": 28,
    "model_type": "qwen2_vl",
    "num_attention_heads": 12,
    "num_hidden_layers": 28,
    "num_key_value_heads": 2,
    "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0,
    "sliding_window": 32768,
    "tie_word_embeddings": True,
    "torch_dtype": "bfloat16",
    "use_cache": True,
    "use_sliding_window": False,
    "vision_config": {"depth": 32, "embed_dim": 1280, "mlp_ratio": 4, "num_heads": 16, "in_chans": 3,
                      "hidden_size": 1536, "patch_size": 14, "spatial_merge_size": 2, "spatial_patch_size": 14,
                      "temporal_patch_size": 2},
    "rope_scaling": {"type": "mrope", "mrope_section": [16, 24, 24]},
    "vocab_size": 151936,
}


@pytest.mark.parametrize("nested", [False, True], ids=["flat", "text_config"])
def test_from_hf_dict_qwen2_vl_2b(nested):
    d = dict(QWEN2_VL_2B)
    if nested:  # newer exports nest the text fields
        keys = ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
                "num_key_value_heads", "vocab_size", "rope_theta", "tie_word_embeddings")
        d["text_config"] = {k: d.pop(k) for k in keys}
        d["hidden_size"] = 999  # a stale top-level value the nested one overrides
    got, want = tq.ModelConfig.from_hf_dict(d), jq.ModelConfig.from_hf_dict(d)
    assert dataclasses.asdict(got.vision) == dataclasses.asdict(want.vision)
    assert got.vision == tv.VisionConfig()  # the defaults are exactly this tower
    fields = [f.name for f in dataclasses.fields(tq.ModelConfig) if f.name != "vision"]
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
    assert (got.image_token_id, got.hidden_size, got.num_layers) == (151655, 1536, 28)


def _write_vlm_checkpoint(tmp_path, params, jcfg, with_tower=True):
    """A Qwen2-VL-style directory: the decoder under HF names and the tower
    under ``visual.*`` with the Conv3d patch kernel [D, 3, 1, 4, 4]."""
    tensors = {}
    for path, (hf_name, transpose) in jq.hf_name_map(jcfg).items():
        parts = path.split("/")
        a = params["layers"][parts[2]][int(parts[1])] if parts[0] == "layers" else params[parts[0]]
        tensors[hf_name] = torch.from_numpy(np.array(a.T if transpose else a))
    if with_tower:
        v = params["vision"]
        for path, (hf_name, transpose) in jv.hf_vision_name_map(jcfg.vision).items():
            parts = path.split("/")
            a = v["layers"][parts[2]][int(parts[1])] if parts[0] == "layers" else v[path]
            a = np.array(a.T if transpose else a)
            if hf_name == "visual.patch_embed.proj.weight":
                a = a.reshape(a.shape[0], 3, 1, 4, 4)
            tensors[hf_name] = torch.from_numpy(a)
    save_tensors(tensors, str(tmp_path / "model.safetensors"))
    d = {"model_type": "qwen2_vl", "vocab_size": 128, "hidden_size": 64, "intermediate_size": 128,
         "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2, "rope_theta": 1e6,
         "tie_word_embeddings": False, "image_token_id": IMAGE_TOKEN,
         "vision_config": {"embed_dim": 32, "intermediate_size": 64, "depth": 2, "num_heads": 4, "patch_size": 4,
                           "in_channels": 3, "temporal_patch_size": 1, "spatial_merge_size": 2}}
    (tmp_path / "config.json").write_text(json.dumps(d))


def test_hf_visual_load_matches_jax(tmp_path, caplog):
    """Both loaders read the same directory into the same tower (exactly);
    without ``visual.*`` both warn and start a fresh tower."""
    jcfg = jq.ModelConfig.from_hf_dict(json.loads(json.dumps({
        "model_type": "qwen2_vl", "vocab_size": 128, "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2, "tie_word_embeddings": False,
        "image_token_id": IMAGE_TOKEN, "vision_config": {"embed_dim": 32, "intermediate_size": 64, "depth": 2,
                                                         "num_heads": 4, "patch_size": 4, "in_channels": 3,
                                                         "temporal_patch_size": 1, "spatial_merge_size": 2}})))
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    params = jax.tree.map(np.asarray, jq.init_params(jax.random.PRNGKey(3), jcfg))
    _write_vlm_checkpoint(tmp_path, params, jcfg)
    jparams, _ = jhf.load_params_from_hf(str(tmp_path), jcfg, dtype=jnp.float32)
    model, cfg = thf.load_params_from_hf(str(tmp_path), dtype="float32", device="cpu")
    assert cfg.vision == port_vcfg(jcfg.vision) and cfg.vision.patch_dim == 48
    want = convert.from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    got = model.state_dict()
    assert set(got) == set(want) and any(n.startswith("vision.layers.") for n in got)
    for n, t in got.items():
        torch.testing.assert_close(t, want[n], rtol=0, atol=0)
    # no tower in the files: a warning and a fresh tower from the seed
    (tmp_path / "model.safetensors").unlink()
    _write_vlm_checkpoint(tmp_path, params, jcfg, with_tower=False)
    assert not thf.checkpoint_has_vision(str(tmp_path))
    with caplog.at_level(logging.WARNING):
        fresh, _ = thf.load_params_from_hf(str(tmp_path), dtype="float32", device="cpu", vision_seed=5)
    assert "no visual.* weights" in caplog.text
    again, _ = thf.load_params_from_hf(str(tmp_path), dtype="float32", device="cpu", vision_seed=5)
    assert torch.equal(fresh.vision.layers.wqkv, again.vision.layers.wqkv)
    assert (fresh.vision.merger_norm == 1).all() and not fresh.vision.layers.bo.any()
    assert "vision" not in jhf.load_params_from_hf(str(tmp_path), jcfg, dtype=jnp.float32)[0]
    # in place with vision_seed=None the tower stays as it was
    before = model.vision.layers.wqkv.clone()
    thf.load_params_from_hf(str(tmp_path), model=model, vision_seed=None)
    assert torch.equal(model.vision.layers.wqkv, before)


def test_write_hf_config_refuses_a_vlm(tmp_path):
    with pytest.raises(AssertionError):
        jhf.write_hf_config(JMCFG, str(tmp_path))
    with pytest.raises(ValueError, match="vision_config"):
        thf.write_hf_config(port_mcfg(JMCFG), str(tmp_path))


def test_bridge_carries_the_tower():
    """``from_jax_params`` / ``to_jax_params`` with the ``vision`` subtree:
    exact, both ways, names one to one."""
    params = jax_vlm_params(seed=2)
    cfg = port_mcfg(JMCFG)
    state = convert.from_jax_params(params, cfg)
    model = tq.QwenModel(cfg, device="cpu")
    assert set(state) == set(model.state_dict())
    back = convert.to_jax_params(state, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    # init_params of the port fills the tower (norms 1, biases 0)
    fresh = tq.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert (fresh.vision.layers.norm1 == 1).all() and not fresh.vision.layers.bo.any()
    assert fresh.vision.patch_embed.abs().max() <= 0.04 and fresh.vision.patch_embed.std() > 0.01


def _vision_traj(n_tok: int, n_patch: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "input_ids": rng.integers(0, 100, n_tok).astype(np.int32),
        "loss_mask": np.ones(n_tok, np.float32),
        "pixel_values": rng.standard_normal((n_patch, 48)).astype(np.float32),
        "pixel_counts": np.int32(n_patch),
        "pixel_pos_ids": rng.integers(0, 6, (n_patch, 2)).astype(np.int32),
        "rewards": np.float32(seed),
    }


def test_ragged_pixel_batching_matches_jax():
    """Pixel keys pad to their own longest row, tokens to theirs, in
    ``pad_sequences_to_tensors`` and ``concat_padded_tensor_dicts``."""
    a = [_vision_traj(5, 8, 0), _vision_traj(9, 4, 1)]
    b = [_vision_traj(7, 12, 2)]
    got = tdata.concat_padded_tensor_dicts([tdata.pad_sequences_to_tensors(a), tdata.pad_sequences_to_tensors(b)])
    want = jdata.concat_padded_tensor_dicts([jdata.pad_sequences_to_tensors(a), jdata.pad_sequences_to_tensors(b)])
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    assert got["pixel_values"].shape == (3, 12, 48) and got["input_ids"].shape == (3, 9)


def test_client_body_matches_jax():
    """The /generate body of an image request, byte for byte: the patches
    as base64 ``np.save`` bytes of f32, the grid as a list; the server
    parses them back exactly."""
    px = _patches(24, seed=4).astype(np.float64)  # the client casts to f32
    grid = np.array([[1, 4, 6]])
    bodies = {}

    async def run(client, post_name, req, key):
        async def capture(addr, path, payload, *a, **k):
            bodies[key] = json.dumps(payload).encode()
            data = {"output_tokens": [1], "output_logprobs": [-0.5], "output_versions": [0], "stop_reason": "length",
                    "latency": 0.1, "ttft": 0.05}
            return (addr, data) if post_name == "_post_json_failover" else data

        setattr(client, post_name, capture)
        await client.agenerate(req)

    jc = RemoteJaxEngine(JInferenceEngineConfig(), addresses=["127.0.0.1:1"])
    tc = RemoteTorchEngine(InferenceEngineConfig(), addresses=["127.0.0.1:1"])
    try:
        asyncio.run(run(jc, "_post_json_failover", JModelRequest(
            rid="r1", input_ids=[1, 9, 9, 2], image_data=px, image_grid_thw=grid,
            gconfig=JGen(max_new_tokens=1)), "jax"))
        asyncio.run(run(tc, "_post_json", ModelRequest(
            rid="r1", input_ids=[1, 9, 9, 2], image_data=px, image_grid_thw=grid,
            gconfig=GenerationHyperparameters(max_new_tokens=1)), "port"))
    finally:
        tc.destroy()
    assert bodies["port"] == bodies["jax"]
    req = tserver._req_from_json(json.loads(bodies["port"]))
    np.testing.assert_array_equal(req.image_data, px.astype(np.float32))
    assert req.image_data.dtype == np.float32 and req.image_grid_thw == [[1, 4, 6]]
    payload = json.loads(bodies["port"])
    assert np.load(io.BytesIO(base64.b64decode(payload["image_data"]))).shape == (24, 48)
