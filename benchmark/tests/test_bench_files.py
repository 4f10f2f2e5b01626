"""A later change adds a configuration, a traffic mix and a per-layer
metric as files of their own, and entries in ``BENCHMARK.json``: the
harness picks them up by name, with no file of it edited."""

import json
import os
import shutil
import subprocess
import sys

from benchmark.tests.conftest import REPO, copy_checkout

PROBE = """
import json, sys
from benchmark.cell import load_cell, metrics_of
from benchmark.trace import Context, load_module
bench, cell, cfg, traffic, limits = load_cell("new-cell")
names = [m["name"] for m in metrics_of(bench, cell, "per_layer")]
ctx = Context(workload=cell, config=cfg, traffic=traffic, trace=None,
              dispatch_ms=[1.0, 3.0], scene=None, device="cpu")
print(json.dumps({"config": cfg["name"], "rate": traffic.get("rate_fps"),
                  "scene": traffic["scene"]["poses"], "metrics": names,
                  "value": load_module("metrics", "new_metric.x").read(ctx),
                  "limits": limits}))
"""


def test_new_files_are_picked_up_by_name(tmp_path):
    root = copy_checkout(str(tmp_path))
    before = {}
    for folder, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            with open(os.path.join(folder, f), "rb") as fh:
                before[os.path.join(folder, f)] = fh.read()
    b = os.path.join(root, "benchmark")
    cfg = json.load(open(os.path.join(b, "configs",
                                      "comp2-1600x1304-qd2.json")))
    cfg["name"] = "new-config"
    json.dump(cfg, open(os.path.join(b, "configs", "new-config.json"), "w"))
    mix = json.load(open(os.path.join(b, "traffic", "live.json")))
    mix["scene"]["poses"] = 9
    json.dump(mix, open(os.path.join(b, "traffic", "new-mix.json"), "w"))
    os.makedirs(os.path.join(b, "traffic", "new-mix"))
    json.dump({"rate_fps": 17},
              open(os.path.join(b, "traffic", "new-mix", "new-config.json"),
                   "w"))
    shutil.copy(os.path.join(b, "limits", "comp2-1600x1304-qd2.json"),
                os.path.join(b, "limits", "new-config.json"))
    with open(os.path.join(b, "metrics", "new_metric.x.py"), "w") as f:
        f.write("def read(ctx):\n    return max(ctx.dispatch_ms)\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append(dict(bench["configs"][0], name="new-config",
                                 file="benchmark/configs/new-config.json"))
    bench["workloads"].append({"name": "new-cell", "config": "new-config",
                               "traffic": "new-mix", "chips": 1,
                               "why": "a cell added by files"})
    bench["per_layer"].append({"name": "new_metric.x", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "runtime.app.App",
                               "moves": "pose_latency_p50_ms",
                               "workloads": ["new-cell"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    script = os.path.join(root, "probe.py")
    with open(script, "w") as f:
        f.write(PROBE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, REPO]))
    p = subprocess.run([sys.executable, script], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got == {"config": "new-config", "rate": 17, "scene": 9,
                   "metrics": ["new_metric.x"], "value": 3.0,
                   "limits": json.load(open(os.path.join(
                       b, "limits", "new-config.json")))}
    for path, data in before.items():  # nothing that was there changed
        with open(path, "rb") as fh:
            assert fh.read() == data, path
