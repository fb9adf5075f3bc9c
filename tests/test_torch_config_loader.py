"""The port's config loader against the JAX package's, and the port's YAML
reader against PyYAML: ``areal_tpu_torch/utils/yaml_subset.py`` resolves
every example file and every scalar of the table as ``yaml.safe_load``
does, ``load_expr_config`` gives JAX's ``to_dict`` on each example file
with and without overrides, and each of the 42 config dataclasses has
JAX's fields and defaults."""

import dataclasses
import math
import string
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import areal_tpu.api.config as jc
import areal_tpu_torch.api.config as tc
from areal_tpu_torch.utils import yaml_subset

ROOT = Path(__file__).resolve().parent.parent
EXAMPLE_YAMLS = sorted((ROOT / "examples").rglob("*.yaml"))


def _rel(p: Path) -> str:
    return str(p.relative_to(ROOT))


def _same(a, b) -> bool:
    """Equality that takes nan as equal to nan."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


# -- 1. the YAML reader against PyYAML ----------------------------------------


def test_example_yamls_found():
    assert len(EXAMPLE_YAMLS) == 21


@pytest.mark.parametrize("path", EXAMPLE_YAMLS, ids=_rel)
def test_reader_matches_pyyaml_on_example(path):
    text = path.read_text()
    assert _same(yaml_subset.safe_load(text), yaml.safe_load(text))


SCALARS = ["1e-6", "1.0e-5", "2.0e-2", "5.0e-03", "on", "off", "yes", "~", "null", "''", '""', "'a # b'", "-0.5",
           "0x1F", ".inf", "[q, k]", "1.0e5", "012", "1_000", "1:30", "-.inf", ".nan", "No", "True", "0b101", "+3",
           "a b   # trailing", "{a: 1, b: [x, 'y']}", "'it''s'", '"tab\\tu\\u00e9"', "http://h:80/p",
           "a#b", "[]", "{}", "[a, ]", "0o17", "nULL", "y", "-"]


@pytest.mark.parametrize("scalar", SCALARS)
def test_reader_matches_pyyaml_on_scalar(scalar):
    doc = f"key: {scalar}\nlist:\n- {scalar}\n"
    try:
        want = yaml.safe_load(doc)
    except yaml.YAMLError:
        with pytest.raises(ValueError):
            yaml_subset.safe_load(doc)
        return
    assert _same(yaml_subset.safe_load(doc), want)


_TEXT = st.text(alphabet=string.ascii_letters + string.digits + " :#-'\",.[]{}!&*|>%@?_~\\/", max_size=20)
_SCALAR = st.one_of(st.none(), st.booleans(), st.integers(-10**12, 10**12), st.floats(allow_nan=False),
                    st.sampled_from(SCALARS), _TEXT)
_KEY = st.text(alphabet="abcdefghijklmnopqrstuvwxyz_", min_size=1, max_size=8)
_TREE = st.recursive(_SCALAR, lambda inner: st.one_of(st.lists(inner, max_size=4),
                                                      st.dictionaries(_KEY, inner, max_size=4)), max_leaves=16)


@settings(max_examples=150, deadline=None, suppress_health_check=list(HealthCheck), derandomize=True)
@given(st.dictionaries(_KEY, _TREE, max_size=5))
def test_reader_matches_pyyaml_on_dumped_trees(tree):
    doc = yaml.safe_dump(tree)
    assert _same(yaml_subset.safe_load(doc), yaml.safe_load(doc))


@pytest.mark.parametrize("doc", [
    "a: &x 1\nb: *x\n",
    "a: |\n  text\n",
    "a: >\n  text\n",
    "a: !!str 1\n",
    "a: 1\n---\nb: 2\n",
    "a: 'open\n  quote'\n",
    "a: [1,\n  2]\n",
    "? complex\n: key\n",
    "a: <<\n",
    "a: 2024-01-31\n",
], ids=["anchor", "block-literal", "block-folded", "tag", "two-documents", "multi-line-quoted", "multi-line-flow",
        "complex-key", "merge", "date"])
def test_reader_raises_outside_subset(doc):
    with pytest.raises(ValueError, match="YAML line"):
        yaml_subset.safe_load(doc)


# -- 2. the loader twin ---------------------------------------------------------


def _config_class(path: Path) -> str:
    if "sft" in path.name:
        return "SFTConfig"
    if path.name.endswith("_rw.yaml"):
        return "RWConfig"
    return "GRPOConfig"


def _overrides(cls: str) -> dict[str, list[str]]:
    eng = "actor" if cls == "GRPOConfig" else "model"
    optional = "critic.eps_clip=0.3" if cls == "GRPOConfig" else "valid_dataset.batch_size=4"
    return {
        "none": [],
        "float-3e-4": [f"{eng}.optimizer.lr=3e-4", f"{eng}.optimizer.eps=1e-6"],
        "str-on": ["recover.mode=on", "experiment_name=yes"],
        "optional-section": [optional],
        "server-precompile": ["server.precompile=true", "server.hbm_utilization=0.9"] if cls == "GRPOConfig"
        else [f"{eng}.pad_to_maximum=true"],
    }


CASES = [(p, name) for p in EXAMPLE_YAMLS for name in _overrides(_config_class(p))]


@pytest.mark.parametrize("path,case", CASES, ids=[f"{_rel(p)}-{c}" for p, c in CASES])
def test_loader_twin(path, case):
    cls = _config_class(path)
    argv = ["--config", str(path), *_overrides(cls)[case]]
    want, wpath = jc.load_expr_config(argv, getattr(jc, cls))
    got, gpath = tc.load_expr_config(argv, getattr(tc, cls))
    assert gpath == wpath == str(path)
    assert _same(tc.to_dict(got), jc.to_dict(want))


@pytest.mark.parametrize("override", ["actor.no_such_key=1", "no_such_section.x=1", "server.not_a_field=2"])
def test_loader_unknown_key_raises_on_both(override):
    argv = ["--config", str(ROOT / "examples/smoke/synthetic_grpo.yaml"), override]
    with pytest.raises((ValueError, AttributeError)) as want:
        jc.load_expr_config(argv, jc.GRPOConfig)
    with pytest.raises(type(want.value)):
        tc.load_expr_config(argv, tc.GRPOConfig)


def test_loader_unknown_yaml_key_raises(tmp_path):
    f = tmp_path / "bad.yaml"
    f.write_text("actor:\n  no_such_key: 1\n")
    for mod in (jc, tc):
        with pytest.raises(ValueError, match="unknown config key 'no_such_key'"):
            mod.load_expr_config(["--config", str(f)], mod.GRPOConfig)


def test_loader_parses_overrides_like_jax():
    """Overrides without a file: YAML 1.1's scalars, the float retry, the raw
    string kept for a str field, a list."""
    argv = ["actor.optimizer.lr=3e-4", "actor.eps_clip_higher=0.28", "recover.mode=off", "seed=7",
            "actor.lora_targets=[wq, wo]", "gconfig.stop_token_ids=[1, 2]", "server.seed=null",
            "actor.group_reward_norm=yes", "tokenizer_path=~"]
    want, _ = jc.load_expr_config(argv, jc.GRPOConfig)
    got, _ = tc.load_expr_config(argv, tc.GRPOConfig)
    assert _same(tc.to_dict(got), jc.to_dict(want))
    assert got.recover.mode == "off" and got.actor.optimizer.lr == 3e-4 and got.tokenizer_path == "~"


# -- 3. the schema twin ---------------------------------------------------------


JAX_CLASSES = sorted(
    (c for c in vars(jc).values()
     if isinstance(c, type) and dataclasses.is_dataclass(c) and c.__module__ == jc.__name__),
    key=lambda c: c.__name__,
)


def _defaults(cls, to_dict) -> dict:
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = to_dict(f.default)
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = to_dict(f.default_factory())
        else:
            out[f.name] = "<required>"
    return out


def test_schema_has_42_classes():
    assert len(JAX_CLASSES) == 42


@pytest.mark.parametrize("jcls", JAX_CLASSES, ids=lambda c: c.__name__)
def test_schema_twin(jcls):
    pcls = getattr(tc, jcls.__name__)
    assert sorted(f.name for f in dataclasses.fields(pcls)) == sorted(f.name for f in dataclasses.fields(jcls))
    assert _same(_defaults(pcls, tc.to_dict), _defaults(jcls, jc.to_dict))
