"""Kernels and small linear algebra.

``ccl_extract`` (B1) and ``segment_stats`` (B2) wrap the hand-written CUDA
kernels in ``csrc/`` (built by ``build``); ``linalg`` holds the small
unpivoted solves.
"""
