"""The readings the correctness limits are set from, in one process: for
each seed, one run of the cell (a short window at the cell's own load,
``cell.run_cell``) gives the program's numbers; the control (the plain
reference computed with TF32 on, the precision below the float32 the
configuration states, put in the program's place over the same frames)
gives the control's; and the reference with the two cameras' mounts
swapped, put in the program's place, gives the numbers of a fault that
the program and its frozen copy would share (``shared_fault``), which
only ``truth_median_m`` can see.

    python3 -m benchmark.calibrate --workload comp2-qd2-live \
        --seeds 101,102,103 --seconds 4

Prints one JSON line a seed ({"seed", "program": {...}, "control":
{...}, "shared_fault": {...}}) and, last, the largest program reading
and the smallest control and fault reading of each number. Needs a CUDA
card; not part of a benchmark run.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def shared_fault(cfg: dict) -> dict:
    """``cfg`` with its cameras' mounts swapped: a wrong extrinsic, as a
    fault in code that the program and the reference both hold would
    give."""
    return dict(cfg, mounts=cfg["mounts"][::-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args(argv)

    from benchmark import compare
    from benchmark.cell import run_cell
    from benchmark.harness import card_line

    worst, least, fault_least = {}, {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(args.workload, seed, args.seconds, False, T_START)
        ex = r["_extra"]
        program = {k: c["value"] for k, c in r["checks"].items()}
        control = compare.reference_outputs(ex["cfg"], ex["scene"],
                                            ex["layout"], "cuda",
                                            precision="tf32")
        ctl = compare.control_gaps(control, ex["ref"], ex["scene"]).v
        fault = compare.reference_outputs(shared_fault(ex["cfg"]), ex["scene"],
                                          ex["layout"], "cuda")
        flt = compare.control_gaps(fault, ex["ref"], ex["scene"]).v
        for k in compare.NUMBERS:
            worst[k] = max(worst.get(k, 0), program[k])
            least[k] = min(least.get(k, float("inf")), ctl[k])
            fault_least[k] = min(fault_least.get(k, float("inf")), flt[k])
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "failed": r["failed"],
                          "truth_gap_m": ex["truth_gap_m"],
                          "program": program, "control": ctl,
                          "shared_fault": flt}), flush=True)
    print(json.dumps({"workload": args.workload, "program_max": worst,
                      "control_min": least, "shared_fault_min": fault_least}),
          flush=True)
    print(f"# card: {card_line()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
