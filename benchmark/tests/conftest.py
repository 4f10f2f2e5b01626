"""The benchmark's own tests: CPU tests of its arithmetic, its inputs and
its harness on a tiny rig (``data/``), and tests marked ``cuda`` that need
a card and skip without one. Run them with ``python -m pytest
benchmark/tests -q``; the card tests alone, on a machine with a card:
``python -m pytest benchmark/tests -m cuda -q``."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TINY_CELLS = ({"name": "tiny-live", "config": "tiny-320x256-qd2",
               "traffic": "tiny-live", "chips": 1,
               "why": "the harness on the CPU: two cameras at 4 fps"},
              {"name": "tiny-saturate", "config": "tiny-320x256-qd2",
               "traffic": "tiny-saturate", "chips": 1,
               "why": "the harness on the CPU: a new frame at every poll"})


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def copy_checkout(dst: str) -> str:
    """A checkout of the benchmark alone (``BENCHMARK.json`` and
    ``benchmark/``) at ``dst``, the program imported from this tree."""
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    return dst


def add_tiny_cells(root: str) -> None:
    """Add the tiny rig's files and cells to the checkout at ``root``: new
    files, and new entries in its ``BENCHMARK.json``."""
    import json

    for folder, _, files in os.walk(DATA):
        rel = os.path.relpath(folder, DATA)
        os.makedirs(os.path.join(root, "benchmark", rel), exist_ok=True)
        for f in files:
            shutil.copy(os.path.join(folder, f),
                        os.path.join(root, "benchmark", rel, f))
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"] += list(TINY_CELLS)
    for m in bench["end_to_end"] + bench["per_layer"]:
        cells = m.get("workloads")
        if cells is None:
            continue
        if any(c.endswith("-live") for c in cells):
            cells.append("tiny-live")
        if any(c.endswith("-saturate") for c in cells):
            cells.append("tiny-saturate")
    with open(path, "w") as f:
        json.dump(bench, f)


def run_in(root: str, args: list, timeout: float = 600) -> subprocess.CompletedProcess:
    """``python -m <args>`` in the checkout at ``root``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, REPO]))
    return subprocess.run([sys.executable, "-m", *args], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="session")
def tiny_checkout(tmp_path_factory):
    root = copy_checkout(str(tmp_path_factory.mktemp("checkout")))
    add_tiny_cells(root)
    return root
