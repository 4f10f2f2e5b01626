"""The benchmark of ``chalkydri_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(also ``python3 -m benchmark.run ...``), from the root of a checkout on a
machine with a CUDA card. The cell's entry in ``BENCHMARK.json`` names
its configuration and traffic mix; ``--trace 0`` reports its end-to-end
metrics, ``--trace 1`` its per-layer metrics from a profiled stretch of
the window. The last line of standard output is the result, one JSON
object; the last lines of standard error give each number the
correctness check compared, beside its limit. Without a card, or with
JAX or the JAX package loaded once the window has closed, the run exits
with a code other than 0 and prints no result.
"""

import time

T_START = time.monotonic()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == _HERE:
    sys.path[0] = _ROOT  # run as a script: import from the checkout's root
elif _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.guard import check_no_jax, check_reference_alone

    check_no_jax("at start")
    check_reference_alone()
    import torch

    from benchmark.cell import load_cell, run_cell

    _, cell, _, _, _ = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on one", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    from benchmark.harness import card_line

    card = card_line()
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START)
    extra = result.pop("_extra")
    check_no_jax("before the result")
    print(f"# card: {card}; {extra['packets']} packets received",
          file=sys.stderr)
    checks = result["checks"]
    print("correct: " + ("yes" if result["correct"] else "NO"),
          file=sys.stderr)
    for name, c in checks.items():
        print(f"  {name} {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
