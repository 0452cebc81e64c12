"""The in-repo YAML loader (config/yaml_lite.py) on every layout shape the
repo ships, against parsed documents pinned in tests/data/layout_docs.json
(parsed with PyYAML's SafeLoader when pinned)."""

import json
import math
import os
import sys

import pytest

from clique_tpu.config import yaml_lite
from clique_tpu.config.layout import SequenceLayout, _detag

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
with open(os.path.join(DATA, "layout_docs.json")) as _fh:
    PINNED = json.load(_fh)


def _layout_text(name, tmp_path):
    if name.startswith("golden"):
        with open(os.path.join(DATA, name, "layout.yaml.in")) as fh:
            return fh.read()
    sys.path.insert(0, ROOT)
    if name == "bench":
        import bench

        return open(bench.write_dataset(str(tmp_path), 0)["layout"]).read()
    import bench_extra

    path = str(tmp_path / "l.yaml")
    bench_extra._write_layout(path, [
        ("amp_a", "ACGT0000000000000000111111111111ACGT", True),
        ("decoy", "TTTTGGGGCCCC", False)])
    return open(path).read()


@pytest.mark.parametrize("name", ["golden", "golden_pe", "golden_ml",
                                  "bench", "bench_extra"])
def test_layouts_match_pinned_documents(name, tmp_path):
    text = _layout_text(name, tmp_path)
    assert yaml_lite.load(_detag(text)) == PINNED[name]
    if name.startswith("golden"):
        text = text.replace("@ALLOWLIST@", "allow.txt")
    SequenceLayout.from_yaml_string(text)


@pytest.mark.parametrize("plain,want", [
    ("", None), ("~", None), ("null", None),
    ("true", True), ("False", False), ("yes", True), ("off", False),
    ("16", 16), ("-3", -3), ("1_000", 1000), ("0x1F", 31), ("010", 8),
    ("0.75", 0.75), ("-.5", -0.5), ("1.0e+3", 1000.0),
    ("1e5", "1e5"), ("Cas9WT", "Cas9WT"), ("0abc", "0abc"),
])
def test_plain_scalars_resolve_as_yaml_1_1(plain, want):
    got = yaml_lite.resolve(plain)
    assert got == want and type(got) is type(want)


def test_special_floats():
    assert math.isinf(yaml_lite.resolve(".inf"))
    assert yaml_lite.resolve("-.Inf") == float("-inf")
    assert math.isnan(yaml_lite.resolve(".NaN"))


def test_block_structures_quotes_and_comments():
    text = """---
# leading comment
a: 1   # trailing comment
'quoted key': "x # not a comment"
s: 'it''s'
d: "tab\\there \\u00e9"
seq:
- one
- [two, "three, four", {k: v}]
nested:
  - name: first
    vals: {x: 1,
           y: [2, 3]}
  -
    name: second
empty:
flow_empty: {}
"""
    assert yaml_lite.load(text) == {
        "a": 1, "quoted key": "x # not a comment", "s": "it's",
        "d": "tab\there é", "seq": ["one", ["two", "three, four",
                                               {"k": "v"}]],
        "nested": [{"name": "first", "vals": {"x": 1, "y": [2, 3]}},
                   {"name": "second"}],
        "empty": None, "flow_empty": {}}


def test_detagged_read_positions_fold_like_pyyaml():
    """`- !Read1` with its body on the next lines at the key's indent
    parses as sibling keys (the layout loader folds either form)."""
    doc = yaml_lite.load(_detag("reads:\n  - !Read1\n    orientation: X\n"
                                "  - !Read2 {orientation: Y}\n"))
    assert doc == {"reads": [{"Read1": None, "orientation": "X"},
                             {"Read2": {"orientation": "Y"}}]}


@pytest.mark.parametrize("text", [
    "a: &anchor 1\nb: *anchor\n",
    "a: |\n  block\n",
    "a: !!str 1\n",
    "a: plain\n  continued\n",
    "a: [1, 2\n",
])
def test_unsupported_constructs_are_refused(text):
    with pytest.raises(ValueError):
        yaml_lite.load(text)
