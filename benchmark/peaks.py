"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W power limit): HBM3 at 3.35 TB/s, and 67 TFLOP/s of float32 outside
the tensor cores, taken for the 32-bit integer compares and mins the
hand-written kernels do. A run prints the card's name and power limit
beside every share it reports (``harness.card_line``)."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the chip could take: bytes over the memory rate or
    operations over the 32-bit rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S)
