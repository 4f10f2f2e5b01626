"""Generate AprilTag family codebooks (tag36h11, tag36h10, tag25h9,
tag16h5) as .npz data into the port's own ``detector/_data`` (port of
``chalkydri_tpu/tools/gen_families.py``; needs OpenCV).

The reference consumes the umich C libapriltag's built-in family tables via
``apriltag-sys`` (``crates/apriltags/Cargo.toml:10-11``,
family selection at ``crates/apriltags/src/lib.rs:45,258-261``). We extract the
same families from OpenCV's bundled AprilTag dictionaries
(``cv2.aruco.DICT_APRILTAG_36h11`` / ``16h5`` — imported by OpenCV from the
official family definitions) and store them in a canonical form:

- bit (r, c) of tag id ``i`` is 1 iff the rendered tag's interior cell
  (r, c) is white (row-major, row 0 at the top of the canonical upright
  rendering),
- ``codes[i]`` packs the ``dim*dim`` bits MSB-first (bit (0,0) highest).

Rotated variants are derived at load time (``detector/families.py``).

Run:  python -m chalkydri_tpu_torch.tools.gen_families [--check]
"""

from __future__ import annotations

import os

import numpy as np

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "detector", "_data")

FAMILIES = {
    # name: (cv2 dictionary attr, data-grid dim, min hamming distance)
    # The four classic libapriltag families Family::parse accepts that
    # OpenCV bundles; the reference's C detector supports all of them
    # (crates/apriltags/src/lib.rs:229 parses the family from config).
    "tag36h11": ("DICT_APRILTAG_36h11", 6, 11),
    "tag36h10": ("DICT_APRILTAG_36h10", 6, 10),
    "tag25h9": ("DICT_APRILTAG_25h9", 5, 9),
    "tag16h5": ("DICT_APRILTAG_16h5", 4, 5),
}


def extract_family(cv2, dict_attr: str, dim: int) -> np.ndarray:
    d = cv2.aruco.getPredefinedDictionary(getattr(cv2.aruco, dict_attr))
    assert d.markerSize == dim
    n = d.bytesList.shape[0]
    codes = np.zeros(n, dtype=np.uint64)
    cell = 8  # pixels per cell in the rendering
    side = (dim + 2) * cell  # data grid + 1-cell black border each side
    for i in range(n):
        img = d.generateImageMarker(i, side)
        # sample interior cell centers
        bits = np.zeros((dim, dim), dtype=np.uint8)
        for r in range(dim):
            for c in range(dim):
                y = (r + 1) * cell + cell // 2
                x = (c + 1) * cell + cell // 2
                bits[r, c] = 1 if img[y, x] > 127 else 0
        code = np.uint64(0)
        for b in bits.reshape(-1):
            code = (code << np.uint64(1)) | np.uint64(b)
        codes[i] = code
    return codes


def check_min_hamming(codes: np.ndarray, dim: int, expect: int) -> int:
    """Verify the family's minimum pairwise Hamming distance over all
    rotations (the 'h11'/'h5' in the names)."""
    nbits = dim * dim

    def rotate(code):
        bits = np.array(
            [(int(code) >> (nbits - 1 - i)) & 1 for i in range(nbits)], np.uint8
        ).reshape(dim, dim)
        rot = np.rot90(bits, -1)
        out = 0
        for b in rot.reshape(-1):
            out = (out << 1) | int(b)
        return np.uint64(out)

    all_rots = [codes]
    cur = codes
    for _ in range(3):
        cur = np.array([rotate(c) for c in cur], dtype=np.uint64)
        all_rots.append(cur)
    stacked = np.stack(all_rots)  # [4, N]

    n = len(codes)
    # Vectorized pairwise popcount: XOR every code against every rotation
    # of every code, popcount via unpackbits on the byte view, chunked
    # over the second axis to bound memory (36h10's 2320 codes make both
    # the per-pair Python loop and the full [4, N, N, 64] bit tensor
    # intractable).
    min_d = nbits
    chunk = 128
    for lo in range(0, n, chunk):
        blk = stacked[:, lo:lo + chunk]  # [4, C]
        x = blk[:, :, None] ^ codes[None, None, :]  # [4, C, N]
        ham = np.unpackbits(
            x.view(np.uint8).reshape(4, blk.shape[1], n, 8), axis=-1
        ).sum(axis=-1).astype(np.int32)
        diag = np.arange(blk.shape[1])
        ham[0, diag, lo + diag] = nbits  # exclude self at rotation 0 only:
        # self vs own nontrivial rotations still counts (libapriltag's
        # distinct-rotation requirement).
        min_d = min(min_d, int(ham.min()))
    return min_d


def main(check: bool = False, out_dir: str = OUT_DIR) -> None:
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    for name, (attr, dim, h) in FAMILIES.items():
        codes = extract_family(cv2, attr, dim)
        path = os.path.join(out_dir, f"{name}.npz")
        np.savez(path, codes=codes, dim=np.int32(dim), min_hamming=np.int32(h))
        msg = f"{name}: {len(codes)} codes, {dim}x{dim} bits -> {path}"
        if check:
            md = check_min_hamming(codes, dim, h)
            msg += f" (min pairwise hamming incl. rotations: {md})"
        print(msg)


if __name__ == "__main__":
    import sys

    main(check="--check" in sys.argv)
