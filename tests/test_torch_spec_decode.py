"""The port's speculative decoding against the JAX package: the drafters
build the same bundles, and the speculative engine (ngram and tree
drafters, model-dtype and int8 KV pages) emits the same greedy tokens as the
non-speculative port engine and as the JAX speculative engine. Engines are
driven directly, one admission pass and then one round per step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.config import MeshConfig as JMeshConfig
from areal_tpu.api.config import ServerConfig as JServerConfig
from areal_tpu.api.config import SpeculativeConfig as JSpec
from areal_tpu.api.io_struct import GenerationHyperparameters as JGen
from areal_tpu.api.io_struct import ModelRequest as JRequest
from areal_tpu.inference import decode_engine as jde
from areal_tpu.inference import paged_kv as jpk
from areal_tpu.inference import speculative as jsp
from areal_tpu.models import tree as jtree
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu_torch.api.config import ServerConfig, SpeculativeConfig
from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest
from areal_tpu_torch.inference import decode_engine as tde
from areal_tpu_torch.inference import paged_kv as tpk
from areal_tpu_torch.inference import speculative as tsp
from areal_tpu_torch.models import tree as ttree

from test_torch_qwen import jax_params, port_model
from tpu_testing import TINY_QWEN2

PAGE = 16

# acceptance-friendly (periodic: prompt lookup hits) and adversarial
# (random: drafts mostly rejected) prompts
PROMPTS = [
    [7, 3, 9] * 8,
    list(range(50, 82)),
    ([5, 11, 5, 11, 2] * 8)[:36],
    np.random.default_rng(13).integers(1, 250, 40).tolist(),
]
N_NEW = 24

# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------


def _contexts(seed):
    rng = np.random.default_rng(seed)
    ctx = {}
    for slot in range(5):
        period = int(rng.integers(1, 6))
        base = rng.integers(0, 6, period).tolist()
        ctx[slot] = (base * 12)[: int(rng.integers(4, 40))] + rng.integers(0, 6, int(rng.integers(0, 4))).tolist()
    ctx[5] = [1, 2, 3, 4]  # nothing to look up
    return ctx


@pytest.mark.parametrize("use_radix", [False, True])
@pytest.mark.parametrize("drafter", ["ngram", "tree"])
@pytest.mark.parametrize("seed", [0, 1])
def test_drafters_match_jax(seed, drafter, use_radix):
    kw = dict(enabled=True, drafter=drafter, spec_depth=4, tree_width=3, max_ngram=3, use_radix=use_radix)
    radix = {}
    for mod, name in ((jpk, "jax"), (tpk, "port")):
        pool = mod.PagePool(16)
        tree = mod.RadixPrefixCache(pool, 4, 8)
        ids = [1, 2, 3, 4, 9, 9, 8, 7, 6, 5, 4, 3]
        tree.insert(ids, pool.alloc(3), [0, 0, 0])
        radix[name] = tree
    ctx = _contexts(seed)
    K = JSpec(**kw).max_nodes() - 1
    want = jsp.draft_batch(jsp.build_drafter(JSpec(**kw), radix=radix["jax"]), ctx, 7, K)
    got = tsp.draft_batch(tsp.build_drafter(SpeculativeConfig(**kw), radix=radix["port"]), ctx, 7, K)
    for f in ("tokens", "parent_row", "depth", "mask", "n_draft"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.sources == want.sources
    assert got.n_draft.sum() > 0


def test_build_tree_matches_jax():
    seqs = [[1, 2, 3], [1, 2, 4, 5], [6], [1, 7]]
    a, b = ttree.build_tree(seqs), jtree.build_tree(seqs)
    for f in ("tokens", "parent", "depth"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.ancestor_mask(), b.ancestor_mask())
    assert [x.tolist() for x in a.seq_nodes] == [x.tolist() for x in b.seq_nodes]


def test_speculative_config_validation():
    with pytest.raises(ValueError):
        SpeculativeConfig(drafter="eagle")
    with pytest.raises(ValueError):
        SpeculativeConfig(spec_depth=0)
    assert SpeculativeConfig(drafter="tree", spec_depth=4, tree_width=2).max_nodes() == 9
    assert SpeculativeConfig(drafter="ngram", spec_depth=4).max_nodes() == 5


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def _kw(**over):
    kw = dict(max_batch_size=4, max_seq_len=256, page_size=PAGE, decode_steps_per_call=4, seed=0)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def weights():
    return jax_params(TINY_QWEN2, seed=8)


def _port(weights, spec=None, **over):
    cfg = ServerConfig(**_kw(**over))
    if spec is not None:
        cfg.speculative = spec
    eng = tde.DecodeEngine(cfg, params=port_model(TINY_QWEN2, weights), device="cpu")
    eng.initialize()
    return eng


def _drive(eng, reqs, spec: bool):
    """Submit together; then admission and one spec round (or one chunk and
    its drain) per step until every slot is free."""
    out = [None] * len(reqs)
    for i, r in enumerate(reqs):
        eng.submit(r, lambda resp, i=i: out.__setitem__(i, resp))
    with torch.no_grad():
        for _ in range(200):
            eng._apply_slot_updates(eng._admit_pending())
            if spec:
                eng._spec_round()
            else:
                eng._drain(eng._dispatch_chunk())
            if not any(t is not None for t in eng._slot_task) and not eng._backlog and eng._queue.empty():
                break
    assert all(o is not None for o in out)
    return [o.output_tokens for o in out]


def _reqs(req_cls, gen_cls):
    return [req_cls(input_ids=list(p), gconfig=gen_cls(max_new_tokens=N_NEW, greedy=True)) for p in PROMPTS]


@pytest.fixture(scope="module")
def baselines(weights):
    """The non-speculative port engine's greedy tokens, per KV mode."""
    return {
        kv: _drive(_port(weights, kv_quantization=kv), _reqs(ModelRequest, GenerationHyperparameters), False)
        for kv in ("none", "int8")
    }


def _jax_spec_tokens(weights, spec_kw, kv):
    jcfg = JServerConfig(**_kw(kv_quantization=kv), mesh=JMeshConfig(data=1))
    jcfg.speculative = JSpec(**spec_kw)
    eng = jde.DecodeEngine(
        jcfg, params=jax.tree.map(jnp.asarray, weights), model_cfg=TINY_QWEN2,
        mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]),
    )
    eng.initialize()
    return _drive(eng, _reqs(JRequest, JGen), True), eng.stats


@pytest.mark.parametrize(
    "drafter,kv", [("ngram", "none"), ("tree", "none"), ("ngram", "int8"), ("tree", "int8")]
)
def test_spec_engine_greedy_identical(weights, baselines, drafter, kv):
    spec_kw = dict(enabled=True, drafter=drafter)
    eng = _port(weights, spec=SpeculativeConfig(**spec_kw), kv_quantization=kv)
    got = _drive(eng, _reqs(ModelRequest, GenerationHyperparameters), True)
    assert got == baselines[kv]
    assert eng.stats["spec_rounds"] > 0 and eng.stats["spec_accepted_tokens"] > 0
    audit = eng.pool_audit()
    assert audit["ok"] and audit["free"] + audit["radix_pages"] == audit["total"]
    if (drafter, kv) in (("tree", "none"), ("ngram", "int8")):
        want, jstats = _jax_spec_tokens(weights, spec_kw, kv)
        assert got == want
        for k in ("spec_rounds", "spec_draft_tokens", "spec_accepted_tokens", "spec_rollback_pages"):
            assert eng.stats[k] == jstats[k], k


def test_rejected_drafts_roll_back_pages(weights):
    """Rejected tails free their pages every round: rollback is observed and
    afterwards every page is free or held by the radix tree."""
    eng = _port(weights, spec=SpeculativeConfig(enabled=True, drafter="tree"), max_batch_size=2)
    reqs = [ModelRequest(input_ids=list(p), gconfig=GenerationHyperparameters(max_new_tokens=40, greedy=True))
            for p in PROMPTS]
    _drive(eng, reqs, True)
    assert eng.stats["spec_rollback_pages"] > 0
    audit = eng.pool_audit()
    assert audit["ok"] and audit["free"] + audit["radix_pages"] == audit["total"]


def test_set_speculative_switches_modes(weights, baselines):
    eng = _port(weights)
    eng.set_speculative(True)
    assert isinstance(eng._drafter, tsp.NgramDrafter) and eng._drafter.radix is eng._radix
    got = _drive(eng, _reqs(ModelRequest, GenerationHyperparameters), True)
    assert got == baselines["none"]
    eng.set_speculative(False)
    assert eng._spec_cfg is None and not eng.config.speculative.enabled
