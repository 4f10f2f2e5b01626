"""Kernels and small linear algebra.

``ccl_extract`` (B1), ``segment_stats`` (B2), ``threshold_ccl`` (B3, B4,
B5), ``propagate`` (B6) and ``extract_blocked`` (B7) wrap the hand-written
CUDA kernels in ``csrc/`` (built by ``build``);
``linalg`` holds the small unpivoted solves.
"""
