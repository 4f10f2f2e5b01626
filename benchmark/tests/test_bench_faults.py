"""The check fails a run whose timed path is broken underneath: a step that
returns its state unchanged, half of the batch left out, and an answer
altered where it is produced (one chip: no exchange between chips); and
a fault that the program and the reference share, a camera's mount."""

import json

import pytest

from benchmark.tests.conftest import run_in


@pytest.mark.parametrize("fault, fails", [
    ("stale", ("ids_differ", "xy_m")),
    ("half_batch", ("ids_differ", "xy_m")),
    ("altered", ("xy_m",)),
    ("shared_mount", ("truth_median_m",)),
])
def test_fault_makes_correct_false(tiny_checkout, fault, fails):
    p = run_in(tiny_checkout, ["benchmark.tests.tiny", "--workload",
                               "tiny-saturate", "--seconds", "2",
                               "--fault", fault])
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert not r["correct"]
    over = [k for k, c in r["checks"].items() if c["value"] > c["limit"]]
    assert any(k in over for k in fails), r["checks"]
