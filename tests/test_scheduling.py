"""The root conftest's xdist scheduling names tests that exist."""

import ast
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _root_conftest():
    spec = importlib.util.spec_from_file_location("root_conftest", ROOT / "conftest.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _nodeids(path):
    tree = ast.parse((ROOT / path).read_text())
    ids = {f"{path}::{f.name}" for f in tree.body if isinstance(f, ast.FunctionDef)}
    for cls in (c for c in tree.body if isinstance(c, ast.ClassDef)):
        ids |= {
            f"{path}::{cls.name}::{f.name}"
            for f in cls.body
            if isinstance(f, ast.FunctionDef) and f.name.startswith("test_")
        }
    return ids


@pytest.mark.parametrize("nodeid", _root_conftest().LONGEST_FIRST)
def test_longest_first_names_a_test_of_a_split_file(nodeid):
    conf = _root_conftest()
    path = nodeid.split("::", 1)[0]
    assert path in conf.SPLIT_FILES
    assert nodeid in _nodeids(path)


def test_unit_rank_orders_split_units_before_files():
    conf = _root_conftest()
    first = conf.LONGEST_FIRST
    assert [conf.unit_rank(s) for s in first] == list(range(len(first)))
    assert conf.unit_rank("tests/test_data.py::TestTiling::test_tile_coords_cover_edges") == len(first)
    assert conf.unit_rank("tests/test_losses.py") is None
