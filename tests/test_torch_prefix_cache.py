"""The port's radix prefix cache and prefix sharing against the JAX package.

``RadixPrefixCache`` runs the same seeded sequences of operations as the JAX
class, result for result and pool state for pool state. The engines are
driven directly (admission, one chunk, drain; no loop thread) and compared
by greedy tokens: warm admissions against the cold port engine and the JAX
engine with prefix caching on."""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.config import MeshConfig as JMeshConfig
from areal_tpu.api.config import ServerConfig as JServerConfig
from areal_tpu.api.io_struct import GenerationHyperparameters as JGen
from areal_tpu.api.io_struct import ModelRequest as JRequest
from areal_tpu.inference import decode_engine as jde
from areal_tpu.inference import paged_kv as jpk
from areal_tpu.parallel import mesh as mesh_lib
from areal_tpu_torch.api.config import PrefixCacheConfig, ServerConfig
from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest
from areal_tpu_torch.inference import decode_engine as tde
from areal_tpu_torch.inference import paged_kv as tpk
from areal_tpu_torch.inference.server import ServerThread

from test_torch_qwen import jax_params, port_model
from tpu_testing import TINY_QWEN2

PSZ = 16

# ---------------------------------------------------------------------------
# the tree, operation for operation
# ---------------------------------------------------------------------------


def _random_ops(seed, n_ops=150):
    """A seeded script of (op, args) over a small vocabulary, so prompts
    share prefixes, plus the page counts the inserts allocate."""
    rng = np.random.default_rng(seed)
    stems = [rng.integers(0, 3, 4 * 6).tolist() for _ in range(4)]
    ops = []
    for _ in range(n_ops):
        stem = stems[int(rng.integers(0, len(stems)))]
        n = int(rng.integers(1, 25))
        ids = stem[: int(rng.integers(0, len(stem)))] + rng.integers(0, 3, n).tolist()
        r = rng.random()
        if r < 0.35:
            ops.append(("insert", ids, int(rng.integers(0, 3))))
        elif r < 0.65:
            ops.append(("match", ids, int(rng.integers(0, 7))))
        elif r < 0.8:
            ops.append(("lookup_extension", ids, int(rng.integers(1, 9))))
        elif r < 0.95:
            ops.append(("evict", None, int(rng.integers(1, 4))))
        else:
            ops.append(("flush", None, None))
    return ops


def _play(mod, ops, psz=4, max_pages=10):
    pool = mod.PagePool(64)
    tree = mod.RadixPrefixCache(pool, psz, max_pages)
    results = []
    for op, ids, arg in ops:
        if op == "insert":
            n = len(ids) // psz
            pages = pool.alloc(n) or []
            results.append(tree.insert(ids, pages, [arg] * len(pages)))
            pool.free(pages)  # the publishing slot finishes; the tree keeps its refs
        elif op == "match":
            results.append(tree.match(ids, max_pages=arg))
        elif op == "lookup_extension":
            results.append(tree.lookup_extension(ids, arg))
        elif op == "evict":
            results.append(tree.evict(arg))
        else:
            results.append(tree.flush())
        results.append((tree.pages_held, pool.available, pool._rc.tolist(), list(pool._free)))
    results.append(dict(tree.stats))
    return results


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_radix_cache_matches_jax_class(seed):
    ops = _random_ops(seed)
    assert _play(tpk, ops) == _play(jpk, ops)


def test_radix_cache_audit_and_capacity():
    pool = tpk.PagePool(16)
    tree = tpk.RadixPrefixCache(pool, page_size=2, max_pages=2)
    pages = pool.alloc(3)
    assert tree.insert(list(range(6)), pages, [0, 0, 0]) == 2  # the cap stops it
    pool.free(pages)
    assert sorted(tree.pages()) == sorted(pages[:2]) and pool.used == 2
    assert tree.flush() == 2 and pool.used == 0


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def _kw(**over):
    kw = dict(max_batch_size=4, max_seq_len=256, page_size=PSZ, decode_steps_per_call=8, seed=0)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def weights():
    return jax_params(TINY_QWEN2, seed=8)


def _port(weights, **over):
    eng = tde.DecodeEngine(ServerConfig(**_kw(**over)), params=port_model(TINY_QWEN2, weights), device="cpu")
    eng.initialize()
    return eng


def _drive(eng, reqs, max_chunks=64):
    """Submit ``reqs`` together, then run admission / one chunk / drain until
    every slot is free (no loop thread: one admission pass takes them all)."""
    out = [None] * len(reqs)
    for i, r in enumerate(reqs):
        eng.submit(r, lambda resp, i=i: out.__setitem__(i, resp))
    with torch.no_grad():
        for _ in range(max_chunks):
            eng._apply_slot_updates(eng._admit_pending())
            eng._drain(eng._dispatch_chunk())
            if not any(t is not None for t in eng._slot_task) and not eng._backlog and eng._queue.empty():
                break
    assert all(o is not None for o in out)
    return [o.output_tokens for o in out]


def _greedy(ids, n=8):
    return ModelRequest(input_ids=list(ids), gconfig=GenerationHyperparameters(max_new_tokens=n, greedy=True))


def _jax_engine(weights, **over):
    jcfg = JServerConfig(**_kw(**over), mesh=JMeshConfig(data=1))
    eng = jde.DecodeEngine(
        jcfg,
        params=jax.tree.map(jnp.asarray, weights),
        model_cfg=TINY_QWEN2,
        mesh=mesh_lib.make_mesh(jcfg.mesh, devices=jax.devices()[:1]),
    )
    eng.initialize()
    return eng


def _jax_drive(eng, prompts, n=8):
    out = [None] * len(prompts)
    for i, p in enumerate(prompts):
        eng.submit(JRequest(input_ids=list(p), gconfig=JGen(max_new_tokens=n, greedy=True)),
                   lambda r, i=i: out.__setitem__(i, r))
    for _ in range(64):
        eng._apply_slot_updates(eng._admit_pending())
        eng._drain(eng._dispatch_chunk())
        if not any(t is not None for t in eng._slot_task) and not eng._backlog and eng._queue.empty():
            break
    return [o.output_tokens for o in out]


_RNG = np.random.default_rng(1)
PREFIX = _RNG.integers(0, 256, 64).tolist()  # 4 full pages
TAIL_A = _RNG.integers(0, 256, 20).tolist()
TAIL_B = _RNG.integers(0, 256, 28).tolist()
REPEAT = _RNG.integers(0, 256, 100).tolist()  # 6 full pages + a tail


def test_warm_admissions_match_cold_port_and_jax_engines(weights):
    """A warm repeat (6 cached pages, a 4-token suffix) and a shared prefix
    with a different tail decode exactly what the cold port engine and the
    JAX engine with prefix caching on decode."""
    warm = _port(weights)
    first = _drive(warm, [_greedy(REPEAT), _greedy(PREFIX + TAIL_A)])
    cold_tokens = warm.stats["prefill_tokens"]
    assert warm.prefix_cache_stats()["pages_held"] >= 10 and warm.stats["prefix_cache_hits"] == 0
    second = _drive(warm, [_greedy(REPEAT), _greedy(PREFIX + TAIL_B)])
    assert warm.stats["prefix_cache_hits"] == 2
    assert warm.stats["prefix_hit_tokens"] == 96 + 64  # (100-1)//16 pages + the prefix
    assert warm.stats["prefill_tokens"] - cold_tokens == 4 + 28  # suffixes only
    assert warm.pool_audit()["ok"]

    cold = _port(weights, enable_prefix_caching=False)
    ref = _drive(cold, [_greedy(REPEAT), _greedy(PREFIX + TAIL_B)])
    assert cold.stats["prefix_cache_hits"] == 0 and cold.prefix_cache_stats() == {"enabled": False}
    assert second == ref and second[0] == first[0]

    jeng = _jax_engine(weights)
    _jax_drive(jeng, [REPEAT, PREFIX + TAIL_A])
    jout = _jax_drive(jeng, [REPEAT, PREFIX + TAIL_B])
    assert jeng.stats["prefix_cache_hits"] == 2
    assert jout == second


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_warm_repeat_matches_cold_quantized_kv(weights, kv):
    eng = _port(weights, kv_quantization=kv)
    out = _drive(eng, [_greedy(REPEAT)]) + _drive(eng, [_greedy(REPEAT)])
    assert eng.stats["prefix_cache_hits"] == 1 and out[0] == out[1]


def test_duplicates_alias_pages(weights):
    """Four samples of one prompt in one admission pass: one prefill, three
    aliased slots sharing the full pages (refcount 4) with a private copy of
    the page holding row plen-1; outputs equal a lone request's."""
    p = _RNG.integers(0, 256, 40).tolist()  # 2 full pages + 8 tokens
    eng = _port(weights)
    for _ in range(4):
        eng.submit(_greedy(p), lambda r: None)
    with torch.no_grad():
        eng._apply_slot_updates(eng._admit_pending())
    assert eng.stats["prefills"] == 1 and eng.stats["prefix_shared"] == 3
    shared = eng._slot_pages[0][:2]
    assert all(eng._slot_pages[s][:2] == shared for s in range(4))
    assert [int(eng.pool._rc[pg]) for pg in shared] == [4, 4]
    assert len({eng._slot_pages[s][2] for s in range(4)}) == 4  # private write pages
    assert eng.pool_audit()["ok"]
    with torch.no_grad():
        for _ in range(8):
            eng._drain(eng._dispatch_chunk())
    eng2 = _port(weights)
    outs = _drive(eng2, [_greedy(p)] * 4 + [_greedy(p[:-1])])
    alone = _drive(_port(weights, enable_prefix_caching=False), [_greedy(p)])
    assert outs[:4] == alone * 4
    assert eng2.stats["prefills"] == 2 and eng2.stats["prefix_shared"] == 3
    audit = eng2.pool_audit()
    assert audit["ok"] and audit["free"] + audit["radix_pages"] == audit["total"]


def test_flush_at_commit_keep_policy_and_disabled(weights):
    prompt = _RNG.integers(0, 256, 80).tolist()
    new = port_model(TINY_QWEN2, weights)  # same values: a version bump only
    eng = _port(weights)
    _drive(eng, [_greedy(prompt, 4)])
    assert eng.prefix_cache_stats()["pages_held"] > 0
    eng.update_weights_from_params(new, version=1)
    assert eng.prefix_cache_stats()["pages_held"] == 0 and eng.pool.used == 0
    _drive(eng, [_greedy(prompt, 4)])
    assert eng.stats["prefix_cache_hits"] == 0
    _drive(eng, [_greedy(prompt, 4)])  # republished under v1
    assert eng.stats["prefix_cache_hits"] == 1

    keep = _port(weights, prefix_cache=PrefixCacheConfig(across_updates="keep"))
    _drive(keep, [_greedy(prompt, 4)])
    held = keep.prefix_cache_stats()["pages_held"]
    keep.update_weights_from_params(new, version=1)
    assert keep.prefix_cache_stats()["pages_held"] == held > 0
    _drive(keep, [_greedy(prompt, 4)])
    assert keep.stats["prefix_cache_hits"] == 1

    off = _port(weights, prefix_cache=PrefixCacheConfig(enabled=False))
    _drive(off, [_greedy(prompt, 4)])
    _drive(off, [_greedy(prompt, 4)])
    assert off.prefix_cache_stats() == {"enabled": False}
    assert off.stats["prefix_cache_hits"] == 0 and off.pool.used == 0
    with pytest.raises(ValueError):
        PrefixCacheConfig(across_updates="sometimes")


def test_flush_prefix_cache_over_http(weights):
    cfg = ServerConfig(**_kw(), host="127.0.0.1", port=0)
    srv = ServerThread(cfg, engine=tde.DecodeEngine(cfg, params=port_model(TINY_QWEN2, weights), device="cpu"))
    srv.start()
    try:
        done = threading.Event()
        srv.engine.submit(_greedy(_RNG.integers(0, 256, 60).tolist(), 4), lambda r: done.set())
        assert done.wait(120)
        held = srv.engine.prefix_cache_stats()["pages_held"]
        assert held > 0
        req = urllib.request.Request(f"http://{srv.address}/flush_prefix_cache", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok", "freed_pages": held}
        assert srv.engine.prefix_cache_stats()["pages_held"] == 0
    finally:
        srv.stop()
