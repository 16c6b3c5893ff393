"""No module of the benchmark imports JAX or the JAX package, and the
references and work counts import nothing of the port. Names are compared
by their top-level part, whole: ``adipose_tpu_torch`` is not
``adipose_tpu``."""

import ast

import pytest

from bench_h100 import common

PORT = "adipose_tpu_torch"


def imported(path) -> set[str]:
    """Top-level names of every module ``path`` imports, at any depth."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


SOURCES = sorted(p for p in common.BENCH_DIR.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(common.ROOT)))
def test_no_jax(path):
    assert not imported(path) & set(common.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", [p for p in SOURCES if p.parent.name in ("reference", "work")],
                         ids=lambda p: str(p.relative_to(common.ROOT)))
def test_reference_and_work_import_nothing_of_the_port(path):
    assert PORT not in imported(path)


def test_the_check_compares_whole_top_level_names():
    assert common.forbidden_loaded({"adipose_tpu_torch.models": 1, "jaxtyping": 1}) == []
    assert common.forbidden_loaded({"jax.numpy": 1, "adipose_tpu": 1}) == ["adipose_tpu", "jax"]


def test_the_harness_loads_no_jax_in_a_run():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import bench_h100.run, bench_h100.control, "
            "bench_h100.faults; from bench_h100 import common; "
            "[bench_h100.run.load_file('entries', n) for n in "
            "('segment', 'classifier_tta', 'train_unet')]; "
            "import adipose_tpu_torch.cli.main, adipose_tpu_torch.train.trainer_unet, "
            "adipose_tpu_torch.eval.classifier_eval; "
            "print(common.forbidden_loaded())" % str(common.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
