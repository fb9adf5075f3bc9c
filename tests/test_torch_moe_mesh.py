"""MoE over the mesh's ``expert`` axis, the port against the JAX package on
the CPU: the tiny qwen3_moe config of ``test_torch_moe.py`` (2 layers,
hidden 32, 8 experts, top-2, FFN 24) in f32, from the same numpy weights.

- The MoE FFN (``models/moe.py``), dropless and capacity, in one spawned
  4-rank gloo world (``tests/torch_dist_child.py moe_mesh_world``) on
  three meshes: ``expert=2`` (the data axis holding copies), ``model=2 x
  expert=2`` (the experts' FFN columns split over model) and ``fsdp=2 x
  expert=2`` (two row blocks). Against JAX's ``moe_ffn`` on the same mesh
  (8-device CPU platform) and with no mesh: out, aux, dh and every leaf's
  gradient under sum(out * ct) + 0.3 aux; and against the unsharded port.
- The train engine on ``fsdp=2 x expert=2``: ``forward_batch``, two
  ``train_batch`` steps of the GRPO loss and the parameters, against JAX's
  engine on the same mesh and the unsharded port; the non-expert leaves'
  gradients equal on both expert ranks.
- Checkpoints and HF exports across mesh shapes (``expert=2`` ->
  unsharded -> ``expert=2``), bit for bit.
- A ``DecodeEngine`` on ``mesh.expert=2`` (a spawned CPU follower) against
  JAX's on the same mesh, driven inline; a staged push; the served slices.
- The allocation strings with ``eN`` and the hybrid MoE spec against
  JAX's ``apply_allocation_mode``.

Tolerances: out and aux at rtol 1e-4 / atol 1e-5 (JAX's own
``tests/test_moe.py:226``); dh and the gradients at rtol 1e-4 / atol 1e-7
(their largest entries are ~1e-2: f32 sums in other orders, measured
below 1e-8); the engine's as ``tests/test_torch_parallel.py``'s mesh twins
(loss and grad norm to 1e-5 relative, logprobs to 1e-5, parameters rtol
1e-5 / atol 1e-6 with Adam's eps at 1e-5); the server's logprobs 1e-5.

JAX's dropless aux on a mesh with data x fsdp above 1 is the mean of the
row blocks' aux (``pmean``), not the grid's, and its gradient follows
(ROADMAP Queue C, the reference semantics to keep); the capacity path's aux is
the grid's. The port keeps both; the test shows the two JAX values apart.
"""

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api import alloc_mode as jam
from areal_tpu.api import config as jc
from areal_tpu.api.io_struct import FinetuneSpec as JFinetuneSpec
from areal_tpu.engine import train_engine as jte
from areal_tpu.inference import decode_engine as jde
from areal_tpu.models.moe import moe_ffn as jmoe_ffn
from areal_tpu.parallel import mesh as jmesh
from areal_tpu.trainer import ppo as jppo
from areal_tpu.utils import data as jdata
from areal_tpu.utils.jax_compat import set_mesh
from areal_tpu_torch.api import alloc_mode as tam
from areal_tpu_torch.api import config as tc
from areal_tpu_torch.api.io_struct import FinetuneSpec, SaveLoadMeta
from areal_tpu_torch.engine.train_engine import TorchTrainEngine
from areal_tpu_torch.inference import decode_engine as tde
from areal_tpu_torch.models import convert, moe
from areal_tpu_torch.models import qwen as tq
from areal_tpu_torch.models.hf import save_params_to_hf
from areal_tpu_torch.trainer import ppo as tppo
from areal_tpu_torch.utils.safetensors_io import SafetensorsFile

import torch_dist_child as child
from test_torch_moe import MOE_CFG
from test_torch_qwen import jax_params, port_cfg, port_model
from test_torch_tp_serving import assert_pools, assert_same, greedy, resume, run
from test_torch_train_engine import _trajs

FFN_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)
LR = 1e-3
ADAM_EPS = 1e-5
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
LOGP_TOL = dict(rtol=1e-5, atol=1e-5)
STAT_RTOL = 1e-5
AUX_COEF = 0.3
COMMON = dict(dtype="float32", param_dtype="float32", bucket_step=64, logprob_chunk_size=48, group_size=4,
              ppo_n_minibatches=2, use_decoupled_loss=True, prox_logp_mode="recompute")
MOE_LEAVES = ("w_router", "we_gate", "we_up", "we_down")
# the port's 4-rank meshes, and the JAX mesh each is held against
MESHES = {
    "expert2": (dict(data=2, expert=2, replicas=True), dict(data=1, expert=2)),
    "model2_expert2": (dict(data=1, model=2, expert=2), dict(data=1, model=2, expert=2)),
    "fsdp2_expert2": (dict(data=1, fsdp=2, expert=2), dict(data=1, fsdp=2, expert=2)),
}
TRAIN_MESH = dict(data=1, fsdp=2, expert=2)
WORLD_TIMEOUT = 240.0
SERVER_KW = dict(max_batch_size=4, max_seq_len=128, page_size=16, decode_steps_per_call=4, seed=0)
PROMPTS = [[7, 3, 9] * 6, list(range(50, 63)), ([5, 11, 5, 11, 2] * 6)[:27], [31, 4, 18, 2, 77]]


def _jax_mesh(kw: dict):
    n = int(np.prod(list(kw.values())))
    return jmesh.make_mesh(jc.MeshConfig(**kw), devices=jax.devices()[:n])


def _jax_ffn(layer: dict, h: np.ndarray, ct: np.ndarray, dropless: bool, mesh_kw: dict | None):
    """JAX's ``moe_ffn`` on ``mesh_kw`` (None: no mesh): out, aux, and the
    gradients of sum(out * ct) + AUX_COEF * aux in h and the layer."""
    cfg = dataclasses.replace(MOE_CFG, moe_dropless=dropless)

    def loss(h, lay):
        out, aux = jmoe_ffn(h, lay, cfg)
        return (out * ct).sum() + AUX_COEF * aux, (out, aux)

    fn = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))
    args = (jnp.asarray(h), jax.tree.map(jnp.asarray, layer))
    if mesh_kw is None:
        (dh, dl), (out, aux) = fn(*args)
    else:
        with set_mesh(_jax_mesh(mesh_kw)):
            (dh, dl), (out, aux) = fn(*args)
    return dict(out=np.asarray(out), aux=float(aux), dh=np.asarray(dh), grads=jax.tree.map(np.asarray, dl))


def _port_ffn(layer: dict, h: np.ndarray, ct: np.ndarray, dropless: bool) -> dict:
    """The unsharded port's ``moe_ffn`` and its gradients, as ``_jax_ffn``."""
    cfg = dataclasses.replace(port_cfg(MOE_CFG), moe_dropless=dropless)
    leaves = {n: torch.from_numpy(a.copy()).requires_grad_(True) for n, a in layer.items()}
    th = torch.from_numpy(h.copy()).requires_grad_(True)
    out, aux = moe.moe_ffn(th, SimpleNamespace(**leaves), cfg, with_aux=True)
    ((out * torch.from_numpy(ct)).sum() + AUX_COEF * aux).backward()
    return dict(out=out.detach().numpy(), aux=float(aux), dh=th.grad.numpy(),
                grads={n: t.grad.numpy() for n, t in leaves.items()})


def _engine_cfg(pkg, **kw):
    return pkg.PPOActorConfig(optimizer=pkg.OptimizerConfig(lr=LR, eps=ADAM_EPS),
                              adv_norm=pkg.NormConfig(mean_level="group", std_level="batch", group_size=4),
                              **COMMON, **kw)


def _port_engine(hf_dir: str, seed: int = 0) -> TorchTrainEngine:
    eng = TorchTrainEngine(_engine_cfg(tc, path=hf_dir), model_config=port_cfg(MOE_CFG), device="cpu")
    eng.initialize(FinetuneSpec(1, 128, 16), seed=seed)
    return eng


def _wfn(d):
    return float((np.asarray(d["loss_mask"]) > 0).sum())


def _jax_train(params, fwd_batch, adv) -> dict:
    """JAX's engine on TRAIN_MESH: forward_batch, two train_batch steps,
    the parameters."""
    jcfg = _engine_cfg(jc, init_from_scratch=True, mesh=jc.MeshConfig(**TRAIN_MESH))
    eng = jte.JaxTrainEngine(jcfg, model_config=MOE_CFG)
    eng.initialize(JFinetuneSpec(1, 128, 16), mesh=_jax_mesh(TRAIN_MESH))
    eng.params = jax.tree.map(lambda old, new: jax.device_put(jnp.asarray(new), old.sharding), eng.params, params)
    out = {"logp": eng.forward_batch(fwd_batch), "stats": []}
    for _ in range(2):
        out["stats"].append(eng.train_batch(adv, lambda o, b: jppo.grpo_loss_fn(o, b, jcfg), _wfn))
    out["params"] = {jax.tree_util.keystr(k): np.asarray(v)
                     for k, v in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, eng.params))}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank world, and beside it (threads) JAX's FFN on every mesh
    and with none, and JAX's engine on TRAIN_MESH; the unsharded port's
    FFN and its engine (two steps, then a recover save the world loads)."""
    tmp = tmp_path_factory.mktemp("moe_mesh")
    params = jax_params(MOE_CFG, seed=7)
    mcfg = port_cfg(MOE_CFG)
    hf_dir = str(tmp / "hf")
    save_params_to_hf(convert.from_jax_params(params, mcfg), mcfg, hf_dir)
    rng = np.random.default_rng(9)
    layer = {n: np.ascontiguousarray(params["layers"][n][0]) for n in MOE_LEAVES}
    h = rng.standard_normal((4, 16, MOE_CFG.hidden_size)).astype(np.float32)
    ct = rng.standard_normal(h.shape).astype(np.float32)
    fwd_batch = jdata.pad_sequences_to_tensors(_trajs(8, seed=10, vocab=MOE_CFG.vocab_size))
    batch = jdata.pad_sequences_to_tensors(_trajs(8, seed=11, vocab=MOE_CFG.vocab_size))
    uns = _port_engine(hf_dir)
    batch["prox_logp"] = uns.forward_batch(batch)
    adv = tppo.PPOActor(uns.config, SimpleNamespace(get_version=lambda: 0)).compute_advantages(batch)
    uns_out = {"logp": uns.forward_batch(fwd_batch), "stats": []}
    for _ in range(2):
        uns_out["stats"].append(uns.train_batch(adv, lambda o, b: tppo.grpo_loss_fn(o, b, uns.config), _wfn))
    uns.save(SaveLoadMeta(path=str(tmp / "unsharded_ckpt"), weight_format="state", with_optim=True))
    payload = {
        "cfg": mcfg, "layer": layer, "h": h, "ct": ct, "coef": AUX_COEF,
        "meshes": {k: dict(v[0]) for k, v in MESHES.items()},
        "models": [("moe", hf_dir, mcfg)], "mesh": TRAIN_MESH,
        "actor": {"lr": LR, "eps": ADAM_EPS, "common": COMMON}, "fwd_batch": fwd_batch, "adv": adv,
        "ckpt_dir": str(tmp / "ckpt"), "hf_out": str(tmp / "hf_out"), "unsharded_ckpt": str(tmp / "unsharded_ckpt"),
    }
    procs = child.start_world("moe_mesh_world", 4, tmp / "world", payload)
    jobs = {(k, path): (k and MESHES[k][1], path == "dropless") for k in [None, *MESHES]
            for path in ("dropless", "capacity")}
    with ThreadPoolExecutor(4) as ex:  # the engine, the longest job, first
        train = ex.submit(_jax_train, params, fwd_batch, adv)
        futs = {key: ex.submit(_jax_ffn, layer, h, ct, dl, mk) for key, (mk, dl) in jobs.items()}
        jax_ffn = {key: f.result() for key, f in futs.items()}
        jax_train = train.result()
    ranks = child.join_world(procs, tmp / "world", WORLD_TIMEOUT)
    port_ffn = {path: _port_ffn(layer, h, ct, path == "dropless") for path in ("dropless", "capacity")}
    return SimpleNamespace(ranks=ranks, jax_ffn=jax_ffn, jax_train=jax_train, port_ffn=port_ffn, uns=uns,
                           uns_out=uns_out, tmp=tmp, mcfg=mcfg, hf_dir=hf_dir)


# ---------------------------------------------------------------------------
# the MoE FFN on a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("path", ["dropless", "capacity"])
def test_moe_ffn_on_a_mesh_matches_jax(world, mesh, path):
    """Every rank's out (its row block), aux, dh and its slice of every
    leaf's gradient against JAX's ``moe_ffn`` on the same mesh; the out,
    aux and gradients against JAX with no mesh and the unsharded port,
    except the dropless aux and what it reaches (dh, the router) over two
    row blocks, where JAX's mesh and no-mesh values part."""
    want, flat, uns = world.jax_ffn[(mesh, path)], world.jax_ffn[(None, path)], world.port_ffn[path]
    specs = tq.param_partition_specs(port_cfg(MOE_CFG))
    m, e = MESHES[mesh][1].get("model", 1), MESHES[mesh][1].get("expert", 1)
    block_aux = path == "dropless" and mesh == "fsdp2_expert2"
    for r in world.ranks:
        got = r["ffn"][f"{mesh}/{path}"]
        tr, er, b, dp = got["at"]
        rows = slice(b * 4 // dp, (b + 1) * 4 // dp)
        assert got["local_experts"] == MOE_CFG.num_experts // e
        np.testing.assert_allclose(got["out"], want["out"][rows], **FFN_TOL)
        np.testing.assert_allclose(got["out"], flat["out"][rows], **FFN_TOL)
        np.testing.assert_allclose(got["out"], uns["out"][rows], **FFN_TOL)
        np.testing.assert_allclose(got["aux"], want["aux"], **FFN_TOL)
        np.testing.assert_allclose(got["dh"], want["dh"][rows], **GRAD_TOL)
        for n in MOE_LEAVES:
            cut = lambda a: tq.tp_slice(torch.from_numpy(np.ascontiguousarray(a)), specs[n], m, tr, e, er).numpy()  # noqa: E731
            np.testing.assert_allclose(got["grads"][n], cut(want["grads"][n]), err_msg=n, **GRAD_TOL)
            if not (block_aux and n == "w_router"):
                np.testing.assert_allclose(got["grads"][n], cut(uns["grads"][n]), err_msg=n, **GRAD_TOL)
        if not block_aux:
            np.testing.assert_allclose(got["aux"], uns["aux"], **FFN_TOL)
            np.testing.assert_allclose(got["dh"], uns["dh"][rows], **GRAD_TOL)
    if block_aux:  # the reference's own mesh and no-mesh values part here
        assert abs(want["aux"] - flat["aux"]) > 1e-4
        assert np.abs(want["grads"]["w_router"] - flat["grads"]["w_router"]).max() > 1e-4
    else:  # JAX on the mesh is JAX with no mesh (no check_vma gap on the expert axis)
        np.testing.assert_allclose(want["aux"], flat["aux"], **FFN_TOL)
        for n in MOE_LEAVES:
            np.testing.assert_allclose(want["grads"][n], flat["grads"][n], err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("e", [2, 4])
@pytest.mark.parametrize("path", ["dropless", "capacity"])
def test_expert_partials_sum_to_the_unsharded_layer(e, path):
    """``EPInfo(group=None, rank=r, size=e)``: each rank's partial output in
    f32 (bf16 input too), unreduced; the e ranks' partials, summed in one
    process, are the unsharded layer's out, and one backward of the sum
    gives its dh and its router's and experts' gradients (the sum of the
    ranks' shares), as ``chip_smoke.py``'s moe_ep sums them on the card."""
    from areal_tpu_torch.parallel.tensor_parallel import EPInfo

    cfg = dataclasses.replace(port_cfg(MOE_CFG), moe_dropless=path == "dropless")
    params = jax_params(MOE_CFG, seed=7)
    layer = {n: torch.from_numpy(np.ascontiguousarray(params["layers"][n][0])) for n in MOE_LEAVES}
    rng = np.random.default_rng(9)
    h = torch.from_numpy(rng.standard_normal((4, 16, MOE_CFG.hidden_size)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal(h.shape).astype(np.float32))
    want = _port_ffn({n: t.numpy() for n, t in layer.items()}, h.numpy(), ct.numpy(), path == "dropless")
    E_loc = MOE_CFG.num_experts // e
    router = layer["w_router"].clone().requires_grad_(True)
    hr = h.clone().requires_grad_(True)
    ranks = [{n: layer[n][r * E_loc:(r + 1) * E_loc].clone().requires_grad_(True) for n in MOE_LEAVES[1:]}
             for r in range(e)]
    total, auxes = 0, []
    for r in range(e):
        o, a = moe.moe_ffn(hr, SimpleNamespace(w_router=router, **ranks[r], ep=EPInfo(None, r, e)), cfg,
                           with_aux=True)
        total, auxes = total + o, auxes + [float(a)]
        bf = moe.moe_ffn(h.bfloat16(), SimpleNamespace(w_router=router, **{n: t.detach().bfloat16() for n, t in
                                                                       ranks[r].items()}, ep=EPInfo(None, r, e)), cfg)[0]
        assert bf.dtype == torch.float32
    ((total * ct).sum() + AUX_COEF * a).backward()
    np.testing.assert_allclose(total.detach().numpy(), want["out"], **FFN_TOL)
    np.testing.assert_allclose(auxes, [want["aux"]] * e, **FFN_TOL)
    np.testing.assert_allclose(hr.grad.numpy(), want["dh"], **GRAD_TOL)
    np.testing.assert_allclose(router.grad.numpy(), want["grads"]["w_router"], **GRAD_TOL)
    for n in MOE_LEAVES[1:]:
        got = torch.cat([rk[n].grad for rk in ranks]).numpy()
        np.testing.assert_allclose(got, want["grads"][n], err_msg=n, **GRAD_TOL)


# ---------------------------------------------------------------------------
# the train engine on fsdp=2 x expert=2
# ---------------------------------------------------------------------------


def _port_params_as_jax(params: dict) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(
        convert.to_jax_params({n: torch.from_numpy(a) for n, a in params.items()}, port_cfg(MOE_CFG)))}


def test_train_engine_on_fsdp_expert_mesh_matches_jax(world):
    """forward_batch on every rank, two train_batch steps (loss, grad norm)
    and the gathered parameters against JAX's engine on the same mesh and
    against the unsharded port; each rank holds 4 of the 8 experts."""
    want, uns = world.jax_train, world.uns_out
    for r in world.ranks:
        assert r["local_experts"] == MOE_CFG.num_experts // 2
        np.testing.assert_allclose(r["twin"]["logp"], want["logp"], **LOGP_TOL)
        np.testing.assert_allclose(r["twin"]["logp"], uns["logp"], **LOGP_TOL)
        for step, (g, w, u) in enumerate(zip(r["twin"]["stats"], want["stats"], uns["stats"])):
            for k in ("loss", "grad_norm", "actor_loss", "n_valid_tokens"):
                np.testing.assert_allclose(g[k], w[k], rtol=STAT_RTOL, err_msg=f"step {step}: {k}")
                np.testing.assert_allclose(g[k], u[k], rtol=STAT_RTOL, err_msg=f"step {step}: {k}")
    assert want["stats"][1]["grad_norm"] > 0
    got = _port_params_as_jax(world.ranks[0]["twin"]["params"])
    assert got.keys() == want["params"].keys()
    for key, w in want["params"].items():
        np.testing.assert_allclose(got[key], w, err_msg=key, **PARAM_TOL)
    for n, t in world.uns.model.named_parameters():
        np.testing.assert_allclose(world.ranks[0]["twin"]["params"][n], t.detach().numpy(), err_msg=n, **PARAM_TOL)
    assert all(r["twin"]["params"] == {} for r in world.ranks[1:])


def test_full_shapes_count_the_whole_model(world):
    """The engine's full shapes of its sharded leaves (``_full_shape``,
    which sizes the snapshot buffers and checks checkpoint shapes on a
    mesh) add up to the unsharded model's parameters on every rank."""
    want = sum(t.numel() for t in world.uns.model.parameters())
    assert [r["full_params"] for r in world.ranks] == [want] * len(world.ranks)


def test_replicated_gradients_equal_over_expert(world):
    """The leaves replicated over ``expert`` get the same gradient on both
    expert ranks (the MoE conjugates), so nothing reduces over it."""
    assert all(r["expert_grad_diff"] == 0.0 for r in world.ranks)


def test_checkpoints_across_mesh_shapes(world):
    """A recover save on fsdp=2 x expert=2 loads on one rank bit for bit and
    the unsharded engine's save of it is the same bytes, its HF export too
    (one tensor a (layer, expert)); an unsharded save loads on the mesh bit
    for bit; the mesh reloads its own save."""
    tmp = world.tmp
    assert all(r["reload_same"] for r in world.ranks)
    for n, t in world.uns.model.named_parameters():
        np.testing.assert_array_equal(world.ranks[0]["loaded_unsharded"][n], t.detach().numpy(), err_msg=n)
    one = _port_engine(world.hf_dir, seed=1)
    one.load(SaveLoadMeta(path=str(tmp / "ckpt"), weight_format="state", with_optim=True))
    for n, t in one.model.named_parameters():
        np.testing.assert_array_equal(t.detach().numpy(), world.ranks[0]["twin"]["params"][n], err_msg=n)
    one.save(SaveLoadMeta(path=str(tmp / "ckpt_again"), weight_format="state", with_optim=True))
    for f in ("params.safetensors", "mu.safetensors", "nu.safetensors", "manifest.json"):
        assert (tmp / "ckpt" / "state" / f).read_bytes() == (tmp / "ckpt_again" / "state" / f).read_bytes(), f
    one.save(SaveLoadMeta(path=str(tmp / "hf_again"), weight_format="hf"))
    files = sorted(p.name for p in (tmp / "hf_out").iterdir())
    assert files == sorted(p.name for p in (tmp / "hf_again").iterdir())
    for f in files:
        assert (tmp / "hf_out" / f).read_bytes() == (tmp / "hf_again" / f).read_bytes(), f
    names = set()
    for f in files:
        if f.endswith(".safetensors"):
            st = SafetensorsFile(str(tmp / "hf_out" / f))
            names.update(st.keys())
            st.close()
    want = {f"model.layers.{i}.mlp.experts.{x}.{p}.weight" for i in range(MOE_CFG.num_layers)
            for x in range(MOE_CFG.num_experts) for p in ("gate_proj", "up_proj", "down_proj")}
    assert want <= names and "model.layers.0.mlp.gate.weight" in names


# ---------------------------------------------------------------------------
# a server on mesh.expert=2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def servers():
    weights = jax_params(MOE_CFG, seed=31)
    jcfg = jc.ServerConfig(**SERVER_KW, mesh=jc.MeshConfig(data=-1, expert=2))
    jeng = jde.DecodeEngine(jcfg, params=jax.tree.map(jnp.asarray, weights), model_cfg=MOE_CFG,
                            mesh=_jax_mesh(dict(data=1, expert=2)))
    jeng.initialize()
    teng = tde.DecodeEngine(tc.ServerConfig(**SERVER_KW, mesh=tc.MeshConfig(expert=2)),
                            params=port_model(MOE_CFG, weights), device="cpu")
    teng.initialize()
    yield jeng, teng
    teng.stop()


def test_expert_mesh_server_matches_jax(servers):
    """A wave on ``mesh.expert=2``: each rank serves 4 of the 8 experts and
    every head; the tokens, logprobs (1e-5) and page counts are JAX's on
    the same mesh; a staged push of new leaves (two buckets) committed as
    version 1 mid-generation gives the same tokens and version tags, and
    every rank then serves its slice of the pushed leaves."""
    jeng, teng = servers
    assert teng._group is not None and len(teng._group.pids()) == 1
    status = teng.mesh_status()
    assert (status["model"], status["expert"], len(status["ranks"])) == (1, 2, 2)
    assert [r["expert_rank"] for r in status["ranks"]] == [0, 1]
    assert teng.local_cfg.num_experts == 4 and teng.local_cfg.num_heads == MOE_CFG.num_heads
    assert_same(run(jeng, greedy("jax", PROMPTS)), run(teng, greedy("port", PROMPTS)))
    assert_pools(jeng, teng)
    new = jax_params(MOE_CFG, seed=32)
    jout = run(jeng, greedy("jax", PROMPTS[:2]), stop_after=2)
    tout = run(teng, greedy("port", PROMPTS[:2]), stop_after=2)
    jflat = {k: v for k, v in new.items() if k != "layers"}
    jflat.update({f"layers/{k}": v for k, v in new["layers"].items()})
    tflat = convert.from_jax_params(new, port_cfg(MOE_CFG))
    for eng, flat in ((jeng, jflat), (teng, tflat)):
        eng.begin_staged_update()
        names = sorted(flat)
        eng.stage_weight_bucket({n: flat[n] for n in names[: len(names) // 2]})
        eng.stage_weight_bucket({n: flat[n] for n in names[len(names) // 2:]})
        eng.commit_staged_weights(version=1)
    resume(jeng)
    resume(teng)
    assert_same(jout, tout, versions=True)
    assert {0, 1} <= set(tout[0].output_versions)
    specs = tq.param_partition_specs(port_cfg(MOE_CFG))
    names = ["embed", "layers.0.w_router", "layers.0.we_gate", "layers.1.we_down", "layers.1.wq"]
    for r, got in enumerate(teng.served_slices(names)):
        for n in names:
            assert torch.equal(got[n], tq.tp_slice(tflat[n], tq.leaf_spec(specs, n), 1, 0, 2, r)), (r, n)
    assert_pools(jeng, teng)


def test_expert_mesh_launch_counts_read_in_order(servers):
    """The launch counts reset as an operation of every rank and read
    through a numbered fence operation: every rank answers (a CPU rank
    launches no kernel, so all read 0), one fence a read."""
    _, teng = servers
    teng.reset_rank_launches()
    seq = teng._fence_seq
    for i in range(2):
        got = teng.rank_launches()
        assert len(got) == 2 and teng._fence_seq == seq + i + 1
        for c in got:
            assert c == {"paged_attention": 0, "paged_suffix_attention": {"chain": 0, "tree": 0}, "gmm": 0}


# ---------------------------------------------------------------------------
# the allocation DSL
# ---------------------------------------------------------------------------

MOE_ALLOC = ["fsdp:d4e2", "sglang:d2e2+fsdp:d4e2", "sglang:d1+megatron:(attn:d4t2|ffn:d2e4)",
             "sglang:(attn:d2t2|ffn:d2e2)+fsdp:d2", "sglang:d4e4+fsdp:d2"]


@pytest.mark.parametrize("s", MOE_ALLOC)
def test_moe_allocation_strings_as_jax(s):
    """``eN`` in either half and the hybrid spec size the same meshes and
    server count as JAX's ``apply_allocation_mode`` (EP borrows the
    data-parallel degree: ``d4e2`` is fsdp 2 x expert 2), and the trainers
    take them."""
    from areal_tpu_torch.trainer.rl_trainer import check_allocation

    got = []
    for pkg, apply in ((jc, jam.apply_allocation_mode), (tc, tam.apply_allocation_mode)):
        cfg = pkg.PPOConfig(allocation_mode=s)
        apply(cfg)
        got.append([dataclasses.asdict(cfg.actor.mesh), dataclasses.asdict(cfg.server.mesh), cfg.launcher.n_servers])
    assert got[0] == got[1]
    check_allocation(tc.PPOConfig(allocation_mode=s))
