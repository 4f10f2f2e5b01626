"""The import guard: whole top-level names, the reference apart from the
program."""

import ast
import os
import subprocess
import sys

from benchmark import guard
from benchmark.tests.conftest import REPO


def test_names_are_compared_whole():
    mods = {"chalkydri_tpu_torch": 1, "chalkydri_tpu_torch.runtime.app": 1,
            "numpy": 1}
    assert guard.forbidden_loaded(mods) == []
    assert guard.forbidden_loaded(dict(mods, **{"chalkydri_tpu.pipeline": 1})
                                  ) == ["chalkydri_tpu"]
    assert guard.forbidden_loaded({"jax.numpy": 1, "jaxlib": 1, "flax": 1}
                                  ) == ["flax", "jax", "jaxlib"]
    assert guard.forbidden_loaded({"jaxtyping": 1}) == []


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; from benchmark import guard; "
            "guard.check_reference_alone(); "
            "print(sorted(guard.top_level() & {'chalkydri_tpu_torch', "
            "'chalkydri_tpu', 'jax'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax():
    bench = os.path.join(REPO, "benchmark")
    for folder, _, files in os.walk(bench):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(folder, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & guard.FORBIDDEN, path
            if os.sep + "reference" + os.sep in path:
                assert guard.PROGRAM not in tops, path


def test_a_run_without_a_card_prints_no_result():
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "comp2-qd2-live",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    import torch

    if torch.cuda.is_available():
        return
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    from benchmark.tests.conftest import copy_checkout

    root = copy_checkout(str(tmp_path))
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "comp2-qd2-live",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
        capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout.strip() == ""
