"""Kernels and small linear algebra.

``ccl_extract`` (B1), ``segment_stats`` (B2), ``threshold_ccl`` (B3, B4,
B5), ``propagate`` (B6), ``extract_blocked`` (B7), ``front`` (X1-X3),
``solve`` (S1) and ``tail`` (T1-T3) wrap the hand-written CUDA kernels in
``csrc/`` (built by ``build``);
``linalg`` holds the small unpivoted solves.
"""
