"""The import guard: the timed process holds neither JAX nor the JAX
package, and the plain reference loads nothing of the program.

Names are compared whole, by their top-level part (before the first
dot): the program's package, ``chalkydri_tpu_torch``, begins with the JAX
package's name, ``chalkydri_tpu``, and is not it."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "chalkydri_tpu"})
PROGRAM = "chalkydri_tpu_torch"
# The benchmark's own modules that must load nothing of the program: the
# plain reference and what feeds it (inputs, comparison, yardstick).
REFERENCE_MODULES = ("benchmark.reference.pipeline", "benchmark.scene",
                     "benchmark.compare", "benchmark.peaks",
                     "benchmark.receiver")


def top_level(modules=None) -> set:
    return {name.split(".", 1)[0] for name in
            (sys.modules if modules is None else modules)}


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: this
    process's ``sys.modules``)."""
    return sorted(top_level(modules) & FORBIDDEN)


def check_reference_alone() -> None:
    """Import the reference's modules before anything of the program and
    raise if they brought the program in."""
    import importlib

    if PROGRAM in top_level():
        raise RuntimeError("the program is loaded before the reference's "
                           "guard ran")
    for name in REFERENCE_MODULES:
        importlib.import_module(name)
    if PROGRAM in top_level():
        raise RuntimeError(f"the reference's modules loaded {PROGRAM}")


def check_no_jax(when: str) -> None:
    bad = forbidden_loaded()
    if bad:
        print(f"import guard ({when}): loaded {', '.join(bad)}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)
