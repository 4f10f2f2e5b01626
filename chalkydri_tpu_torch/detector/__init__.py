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
(``ops/segment_stats.py``). The package imports no submodule itself: the
``ops`` wrappers build their plain twins from the stage modules here, and
``pipeline`` calls the kernels, so import the submodules directly.
"""
