"""The port's command line against the JAX package's, on the CPU: each of the
port's subcommands accepts every option string of the same ``adipose``
subcommand, with the same destination and default; and no module of the
port imports a library that the card's machine does not have."""

import ast
from pathlib import Path

import pytest

from adipose_tpu.cli.main import build_parser as jax_build_parser
from adipose_tpu_torch.cli.main import build_parser

ROOT = Path(__file__).resolve().parents[1]
PORTED = ("segment", "classify", "evaluate", "evaluate-checkpoints", "eval-classifier",
          "tile-classification-eval", "visualize-metrics", "pipeline", "train-unet",
          "train-classifier", "build-dataset", "build-test-dataset", "build-class-dataset",
          "build-test-class-dataset", "run-pipeline", "reconstruct", "classification-overlay",
          "chunk-wsi", "preprocess-ecm", "scale-ecm", "compare-modalities", "tif2jpg")
# the host-only subcommands: no --device
HOST_ONLY = ("visualize-metrics", "classification-overlay", "scale-ecm", "tif2jpg")
# Not on the card's machine (numpy, scipy, einops and cv2 are); the JAX package
# and JAX itself are held out by test_torch_segment.py::test_cli_imports_without_jax.
FORBIDDEN = {"sklearn", "pandas", "matplotlib", "jax", "jaxlib", "adipose_tpu"}


def _subparsers(parser) -> dict:
    return parser._subparsers._group_actions[0].choices


def _options(sub) -> dict:
    """option string -> the action that owns it."""
    return {opt: a for a in sub._actions for opt in a.option_strings if opt not in ("-h", "--help")}


def test_the_port_has_the_ported_subcommands():
    port = _subparsers(build_parser())
    assert set(port) == set(PORTED)
    assert set(PORTED) <= set(_subparsers(jax_build_parser()))


@pytest.mark.parametrize("name", PORTED)
def test_every_jax_flag_parses_with_the_same_default(name):
    """Each option string of ``adipose <name>`` is one of ``adipose-torch
    <name>``'s, with the same dest and default, and the port adds
    ``--device`` defaulting to cuda where device work runs."""
    jax_sub, port_sub = _subparsers(jax_build_parser())[name], _subparsers(build_parser())[name]
    want, got = _options(jax_sub), _options(port_sub)
    missing = sorted(set(want) - set(got))
    assert not missing, f"{name}: {missing}"
    for opt, action in want.items():
        assert (got[opt].dest, got[opt].default) == (action.dest, action.default), opt
        assert got[opt].nargs == action.nargs and got[opt].const == action.const, opt
    extra = sorted(set(got) - set(want))
    assert extra in ([], ["--device"]), f"{name}: {extra}"
    if extra:
        assert got["--device"].default == "cuda"
    assert name in HOST_ONLY or extra == ["--device"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_sklearn_pandas_or_matplotlib():
    """A static check of every import statement in the port and in
    chip_smoke.py, at any depth (function-level imports included)."""
    files = sorted((ROOT / "adipose_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f) & FORBIDDEN) for f in files}
    assert not {k: v for k, v in bad.items() if v}
