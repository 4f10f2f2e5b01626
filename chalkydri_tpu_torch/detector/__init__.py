"""Batched AprilTag detector:

  threshold  -> adaptive tile threshold      (threshold.py)
  segment    -> label-propagation CCL        (segment.py)
  cluster    -> gradient clustering          (cluster.py)
  quad       -> iterative 4-line quad fit    (quad.py)
  refine     -> sub-pixel edge refinement    (refine.py)
  decode     -> homography + codebook match  (homography.py, decode.py)
  pipeline   -> batched detect()             (pipeline.py)

Threshold, CCL and extraction run fused in kernel B1
(``ops/ccl_extract.py``), run-length segmentation in kernel B2
(``ops/segment_stats.py``). The package imports no submodule itself:
``ops.ccl_extract`` builds its plain twin from the stage modules here, and
``pipeline`` calls the kernel, so import the submodules directly.
"""
