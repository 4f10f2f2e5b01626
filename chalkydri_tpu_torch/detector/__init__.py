"""Batched AprilTag detector:

  grayscale  -> color -> GRAY8 on device     (grayscale.py)
  threshold  -> adaptive tile threshold      (threshold.py)
  segment    -> label-propagation CCL        (segment.py)
  cluster    -> gradient clustering          (cluster.py)
  quad       -> iterative 4-line quad fit    (quad.py)
  refine     -> sub-pixel edge refinement    (refine.py)
  decode     -> homography + codebook match  (homography.py, decode.py)
  pipeline   -> batched detect()             (pipeline.py)

Threshold, CCL and extraction run fused in kernel B1
(``ops/ccl_extract.py``); at full resolution (``quad_decimate=1``) past
B1's frame size, threshold and CCL run in kernel B3 (through B4) or B5
(``ops/threshold_ccl.py``). Run-length segmentation is kernel B2
(``ops/segment_stats.py``). The package imports no submodule when it is
imported: the ``ops`` wrappers build their plain twins from the stage
modules here, and ``pipeline`` calls the kernels. The names below are
imported from their submodules on first access.
"""

import importlib

_EXPORTS = {
    "DEFAULT_BITS_CORRECTED": "families",
    "DEFAULT_FAMILY": "families",
    "TagFamily": "families",
    "load_family": "families",
    "render_tag": "families",
    "MAX_DETECTIONS": "pipeline",
    "Detections": "pipeline",
    "make_detector": "pipeline",
    "adaptive_threshold": "threshold",
    "label_components": "segment",
    "gradient_clusters": "cluster",
    "fit_quads": "quad",
    "refine_quads": "refine",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                    name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
