"""The rollout loop's parts in the port against the JAX package's, on the
same inputs (no server): the reward functions, the stats tracker, the
metrics registry and the catalog families, the staleness manager, the async
task runner, and the trajectory checks and batch helpers. Each comparison
is exact (equal results, equal text, equal arrays)."""

import asyncio
import time

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from areal_tpu.infra import async_task_runner as j_runner
from areal_tpu.infra import staleness_manager as j_stale
from areal_tpu.infra.workflow_executor import check_trajectory_format as j_check
from areal_tpu.observability import catalog as j_catalog
from areal_tpu.observability import metrics as j_metrics
from areal_tpu.reward import clevr_count as j_clevr
from areal_tpu.reward import countdown as j_countdown
from areal_tpu.reward import gsm8k as j_gsm8k
from areal_tpu.reward import math_verify as j_math
from areal_tpu.reward import synthetic as j_synth
from areal_tpu.utils import data as j_data
from areal_tpu.utils import stats_tracker as j_stats
from areal_tpu_torch.infra import async_task_runner as t_runner
from areal_tpu_torch.infra import staleness_manager as t_stale
from areal_tpu_torch.infra.workflow_executor import check_trajectory_format as t_check
from areal_tpu_torch.observability import catalog as t_catalog
from areal_tpu_torch.observability import metrics as t_metrics
from areal_tpu_torch.reward import clevr_count as t_clevr
from areal_tpu_torch.reward import countdown as t_countdown
from areal_tpu_torch.reward import gsm8k as t_gsm8k
from areal_tpu_torch.reward import math_verify as t_math
from areal_tpu_torch.reward import synthetic as t_synth
from areal_tpu_torch.utils import data as t_data
from areal_tpu_torch.utils import stats_tracker as t_stats

# derandomized: the same examples every run, no example database on disk
SETTINGS = settings(max_examples=60, deadline=None, derandomize=True, database=None,
                    suppress_health_check=[HealthCheck.too_slow])

# ---------------------------------------------------------------------------
# rewards
# ---------------------------------------------------------------------------

REWARDS = {
    "gsm8k": (j_gsm8k.gsm8k_reward_fn, t_gsm8k.gsm8k_reward_fn),
    "math_verify": (j_math.math_verify_reward_fn, t_math.math_verify_reward_fn),
    "countdown": (j_countdown.countdown_reward_fn, t_countdown.countdown_reward_fn),
    "clevr_count": (j_clevr.clevr_count_reward_fn, t_clevr.clevr_count_reward_fn),
    "arith_char": (j_synth.arith_char_reward_fn, t_synth.arith_char_reward_fn),
    "target_token": (j_synth.target_token_reward_fn, t_synth.target_token_reward_fn),
}

# (completion, keyword arguments) pairs that reach every branch
CORPUS = [
    ("The answer is 42.", dict(answer="#### 42")),
    ("so 1,234 apples", dict(answer="#### 1234")),
    ("we get \\boxed{\\frac{1}{3}}", dict(answer="\\boxed{0.3333333}")),
    ("\\boxed{2\\sqrt{2}} done", dict(answer="2\\sqrt{2}")),
    ("#### -7\n", dict(answer="-7")),
    ("no number here", dict(answer="#### 5")),
    ("<answer>(3 + 5) * 2</answer>", dict(answer="", numbers=[3, 5, 2], target=16)),
    ("<answer>3 * 5 + 2</answer>", dict(answer="", numbers=[3, 5, 2], target=16)),
    ("<answer>3 ** 5</answer>", dict(answer="", numbers=[3, 5], target=243)),
    ("<answer>7 / 0</answer>", dict(answer="", numbers=[7, 0], target=1)),
    ("there are [3] cubes", dict(answer="3")),
    ("[2] or maybe [4]", dict(answer=4)),
    ("12+30=42", dict(answer="#### 42")),
]


def _call(fn, *args, **kw):
    """The result, or the type of what the call raised."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — compared across the two sides
        return type(e)


def _both(name, completion, ids, kw):
    j_fn, t_fn = REWARDS[name]
    return _call(j_fn, "p", completion, [1, 2], ids, **kw), _call(t_fn, "p", completion, [1, 2], ids, **kw)


@pytest.mark.parametrize("name", sorted(REWARDS))
def test_rewards_equal_on_corpus(name):
    for i, (completion, kw) in enumerate(CORPUS):
        ids = [ord(c) for c in completion] + [7 * (i % 2)]
        kw = dict(kw)
        if name == "target_token":
            kw["target"] = 7
        elif name != "countdown":
            kw.pop("numbers", None), kw.pop("target", None)
        j, t = _both(name, completion, ids, kw)
        assert j == t, (name, completion, kw, j, t)


_TEXT = st.text(alphabet=st.sampled_from(list("0123456789+-*/(). ,#[]{}\\boxedfrac<>answer/x=")), max_size=40)


@SETTINGS
@given(completion=_TEXT, answer=_TEXT, ids=st.lists(st.integers(0, 300), max_size=12),
       numbers=st.lists(st.integers(0, 20), min_size=1, max_size=4), target=st.integers(-5, 100))
def test_rewards_equal_on_generated_inputs(completion, answer, ids, numbers, target):
    for name in REWARDS:
        kw = dict(answer=answer)
        if name == "countdown":
            kw = dict(numbers=numbers, target=target)
        elif name == "target_token":
            kw = dict(target=target % 11)
        j, t = _both(name, completion, ids, kw)
        assert j == t, (name, completion, kw, j, t)


# ---------------------------------------------------------------------------
# stats tracker
# ---------------------------------------------------------------------------


def _drive_tracker(mod, seed):
    rng = np.random.default_rng(seed)
    tr = mod.StatsTracker()
    mask = rng.random((4, 9)) > 0.3
    tr.denominator(n_tokens=mask)
    tr.stat(denominator="n_tokens", importance_weight=rng.standard_normal((4, 9)))
    with tr.scope("actor"):
        tr.denominator(seqs=np.ones(4, bool))
        tr.stat(denominator="seqs", reduce_type=mod.ReduceType.SUM, reward=rng.standard_normal(4))
        tr.scalar(lr=1e-3, loss=float(rng.standard_normal()))
        with tr.scope("inner"):
            tr.scalar(x=2.0)
            tr.scalar(x=4.0)
    tr.scalar(rollout_accepted=1.0)
    partial = tr.export(key="actor/inner", reset=True)
    return partial, tr.export()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stats_tracker_exports_equal(seed):
    assert _drive_tracker(j_stats, seed) == _drive_tracker(t_stats, seed)


def test_stats_tracker_named_trackers():
    for mod in (j_stats, t_stats):
        mod.get("test_torch_rollout_parts").scalar(a=3.0)
    j = {k: v for k, v in j_stats.export_all(reset=False).items() if k.startswith("test_torch_rollout_parts")}
    t = {k: v for k, v in t_stats.export_all(reset=False).items() if k.startswith("test_torch_rollout_parts")}
    assert j == t == {"test_torch_rollout_parts/a": 3.0}
    for mod in (j_stats, t_stats):
        mod.get("test_torch_rollout_parts").export()


# ---------------------------------------------------------------------------
# metrics registry and the catalog families
# ---------------------------------------------------------------------------

FAMILIES = ("staleness_metrics", "executor_metrics", "lifecycle_metrics", "client_metrics",
            "robustness_metrics", "preemption_metrics")


def _drive_registry(metrics_mod, catalog_mod, seed):
    rng = np.random.default_rng(seed)
    reg = metrics_mod.Registry()
    fams = {name: getattr(catalog_mod, name)(reg) for name in FAMILIES}
    for ns in fams.values():
        for attr, fam in sorted(vars(ns).items()):
            for _ in range(int(rng.integers(0, 4))):
                child = fam.labels(**{ln: f"v{int(rng.integers(0, 2))}\"\\" for ln in fam.label_names}) \
                    if fam.label_names else fam
                if fam.type == "counter":
                    child.inc(float(rng.integers(1, 5)))
                elif fam.type == "gauge":
                    child.set(float(rng.standard_normal()))
                else:
                    child.observe(float(abs(rng.standard_normal()) * 3))
    mine = reg.counter("areal_test_total", "A test counter.", ["kind"])
    mine.labels(kind="a\nb").inc(2.5)
    return reg.render_prometheus(), reg.render_prometheus(name_prefix="areal_rollout")


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_and_catalog_render_equal(seed):
    j = _drive_registry(j_metrics, j_catalog, seed)
    t = _drive_registry(t_metrics, t_catalog, seed)
    assert j == t
    assert "areal_rollout_version_lag_bucket" in t[0]


@pytest.mark.parametrize(
    "bad",
    [dict(name="bad-name", help="h"), dict(name="areal_x", help=" "), dict(name="areal_y", help="h", type="summary")],
)
def test_registry_refuses_the_same_names(bad):
    for mod in (j_metrics, t_metrics):
        with pytest.raises(ValueError):
            mod.MetricFamily(bad["name"], bad["help"], bad.get("type", "counter"))
    for mod in (j_metrics, t_metrics):
        reg = mod.Registry()
        reg.counter("areal_z_total", "z")
        with pytest.raises(ValueError):
            reg.gauge("areal_z_total", "z")


# ---------------------------------------------------------------------------
# staleness manager
# ---------------------------------------------------------------------------


class _Version:
    def __init__(self):
        self.v = 0

    def get_version(self):
        return self.v


_EVENTS = st.lists(
    st.tuples(st.sampled_from(["submit", "accept", "reject", "version"]), st.integers(0, 3)),
    max_size=40,
)


@SETTINGS
@given(events=_EVENTS, max_conc=st.integers(1, 16), bs=st.integers(1, 8), eta=st.integers(0, 3))
def test_staleness_manager_capacities_equal(events, max_conc, bs, eta):
    sides = []
    for mod in (j_stale, t_stale):
        vp = _Version()
        sides.append((vp, mod.StalenessManager(vp, max_conc, bs, max_staleness=eta)))
    for kind, n in events:
        caps = []
        for vp, m in sides:
            if kind == "submit":
                m.on_submit(n)
            elif kind == "accept":
                m.on_accept(n)
            elif kind == "reject":
                m.on_reject(n)
            else:
                vp.v += n
            caps.append((m.get_capacity(), vars(m.stat), m.export_stats()))
        assert caps[0] == caps[1], (kind, n, caps)
    assert [j_stale.lag_bucket_index(x) for x in range(-2, 9)] == [t_stale.lag_bucket_index(x) for x in range(-2, 9)]


# ---------------------------------------------------------------------------
# async task runner (the cases of tests/test_async_runtime.py
# TestAsyncTaskRunner, on both packages)
# ---------------------------------------------------------------------------

RUNNERS = pytest.mark.parametrize("mod", [j_runner, t_runner], ids=["jax", "torch"])


@RUNNERS
def test_runner_submit_and_poll(mod):
    r = mod.AsyncTaskRunner()
    r.start()
    try:
        async def work():
            await asyncio.sleep(0.01)
            return 42

        tid = r.submit(work)
        deadline = time.monotonic() + 5
        res = None
        while res is None and time.monotonic() < deadline:
            res = r.poll_result(timeout=0.1)
        assert res is not None and res.data == 42 and res.task_id == tid
    finally:
        r.stop()


@RUNNERS
def test_runner_failure_propagates(mod):
    r = mod.AsyncTaskRunner()
    r.start()
    try:
        async def boom():
            raise ValueError("nope")

        r.submit(boom)
        with pytest.raises(mod.TaskFailed):
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if r.poll_result(timeout=0.1) is not None:
                    break
    finally:
        r.stop()


@RUNNERS
def test_runner_pause_blocks_new_tasks(mod):
    r = mod.AsyncTaskRunner()
    r.start()
    try:
        r.pause()
        hits = []

        async def work():
            hits.append(1)
            return 1

        r.submit(work)
        time.sleep(0.2)
        assert not hits
        r.resume()
        deadline = time.monotonic() + 5
        while not hits and time.monotonic() < deadline:
            time.sleep(0.01)
        assert hits
    finally:
        r.stop()


@RUNNERS
def test_runner_semaphore_and_wait_all(mod):
    """max_concurrency bounds the tasks in their body at once; wait_all
    returns when every task is done; drain hands back every result."""
    r = mod.AsyncTaskRunner(max_concurrency=2)
    r.start()
    try:
        live, peak = [0], [0]

        async def work(i):
            live[0] += 1
            peak[0] = max(peak[0], live[0])
            await asyncio.sleep(0.02)
            live[0] -= 1
            return i

        for i in range(6):
            r.submit(lambda i=i: work(i))
        r.wait_all(timeout=10)
        assert r.n_pending == 0 and peak[0] == 2
        assert sorted(x.data for x in r.drain()) == list(range(6))
    finally:
        r.stop()


# ---------------------------------------------------------------------------
# trajectory checks and batch helpers
# ---------------------------------------------------------------------------

TRAJ_CASES = {
    "ok": {"input_ids": np.zeros((2, 5), np.int32), "attention_mask": np.ones((2, 5), bool)},
    "empty": {},
    "not_a_dict": [1, 2],
    "no_mask": {"input_ids": np.zeros((2, 5))},
    "batch_mismatch": {"input_ids": np.zeros((2, 5)), "attention_mask": np.ones((3, 5))},
    "scalar_value": {"input_ids": np.zeros((2, 5)), "attention_mask": np.ones((2, 5)), "rewards": np.float32(1)},
    "per_seq_ok": {"input_ids": np.zeros((2, 5)), "attention_mask": np.ones((2, 5)), "rewards": np.ones(2)},
}


@pytest.mark.parametrize("case", sorted(TRAJ_CASES))
def test_check_trajectory_format_same_verdicts(case):
    verdicts = []
    for fn in (j_check, t_check):
        try:
            fn(TRAJ_CASES[case])
            verdicts.append("ok")
        except ValueError as e:
            verdicts.append(str(e))
    assert verdicts[0] == verdicts[1]


def _trajs(rng, n):
    out = []
    for _ in range(n):
        p, o = int(rng.integers(2, 9)), int(rng.integers(1, 7))
        out.append({
            "input_ids": rng.integers(0, 100, p + o).astype(np.int32),
            "loss_mask": np.concatenate([np.zeros(p, np.float32), np.ones(o, np.float32)]),
            "logprobs": np.concatenate([np.zeros(p, np.float32), -rng.random(o).astype(np.float32)]),
            "versions": np.concatenate([np.full(p, -1, np.int32), rng.integers(0, 3, o).astype(np.int32)]),
            "rewards": np.float32(rng.standard_normal()),
            "seq_no_eos_mask": np.bool_(rng.random() > 0.5),
        })
    return out


def _equal_dicts(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pad_and_concat_equal(seed):
    rng = np.random.default_rng(seed)
    groups = [_trajs(rng, int(rng.integers(1, 5))) for _ in range(3)]
    j_pads = [j_data.pad_sequences_to_tensors(g) for g in groups]
    t_pads = [t_data.pad_sequences_to_tensors(g) for g in groups]
    for j, t in zip(j_pads, t_pads):
        _equal_dicts(j, t)
    j_cat, t_cat = j_data.concat_padded_tensor_dicts(j_pads), t_data.concat_padded_tensor_dicts(t_pads)
    _equal_dicts(j_cat, t_cat)
    assert j_data.batch_size(j_cat) == t_data.batch_size(t_cat) == sum(len(g) for g in groups)
    for mod in (j_data, t_data):
        with pytest.raises(AssertionError):
            mod.concat_padded_tensor_dicts([])


def test_cycle_dataloader_equal():
    loader = [[1, 2], [3], [4, 5, 6]]
    jg, tg = j_data.cycle_dataloader(loader), t_data.cycle_dataloader(loader)
    assert [next(jg) for _ in range(8)] == [next(tg) for _ in range(8)]
