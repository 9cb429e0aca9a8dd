"""Scalar/numpy reference implementations of dequantization and inverse
transforms (spec 8.6.2-8.6.5). These are the bit-exact oracles for the device
kernels (mirroring the role of /root/reference/libde265/fallback-dct.cc for the
SIMD kernels) and the CPU fallback path of the decoder.

All arithmetic is integer and must match the spec exactly.
"""
import numpy as np
from functools import lru_cache

LEVEL_SCALE = (40, 45, 51, 57, 64, 72)  # levelScale[qP%6] (spec 8.6.3)


# The 32 normative base values of the HEVC integer DCT (spec 8.6.4.2):
# DCT32_BASE[k] = transMatrix[k][0] for the 32-point matrix. All other entries
# follow from cosine symmetry (the matrices are *not* plain rounded cosines —
# several values are orthogonality-tuned, so the base table is normative).
DCT32_BASE = (
    64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
    64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4,
)


@lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """HEVC integer DCT-II basis of size n (4/8/16/32), generated from the 32
    normative base values: M_N[k][j] = M_32[k*(32/N)][j], and
    M_32[k][j] = fold(cos symmetry) of DCT32_BASE[(k*(2j+1)) mod 256]."""
    m = np.zeros((n, n), np.int32)
    step = 32 // n
    for k in range(n):
        for j in range(n):
            t = (k * step * (2 * j + 1)) % 128  # angle t*pi/64, period 2pi
            sign = 1
            if t > 64:
                t = 128 - t      # cos(2π−θ) = cos(θ)
            if t > 32:
                t = 64 - t       # cos(π−θ) = −cos(θ)
                sign = -sign
            m[k, j] = 0 if t == 32 else sign * DCT32_BASE[t]
    return m


DST4 = np.array([
    [29, 55, 74, 84],
    [74, 74, 0, -74],
    [84, -29, -74, 55],
    [55, -84, 74, -29],
], np.int32)


def dequant(coeffs: np.ndarray, qp: int, log2_size: int, bitdepth: int = 8,
            scaling_matrix: np.ndarray = None, scaling_dc: int = None) -> np.ndarray:
    """spec 8.6.3 scaling process. coeffs: (n,n) int, returns int32 d[x][y]."""
    bd_shift = bitdepth + log2_size - 5
    c = coeffs.astype(np.int64)
    if scaling_matrix is None:
        m = 16
        factor = (m * LEVEL_SCALE[qp % 6]) << (qp // 6)
        d = (c * factor + (1 << (bd_shift - 1))) >> bd_shift
    else:
        m = scaling_matrix.astype(np.int64)
        if scaling_dc is not None:
            m = m.copy()
            m[0, 0] = scaling_dc
        d = (c * m * LEVEL_SCALE[qp % 6] << (qp // 6)) + (1 << (bd_shift - 1))
        d >>= bd_shift
    return np.clip(d, -32768, 32767).astype(np.int32)


def inv_transform(d: np.ndarray, log2_size: int, is_dst: bool,
                  bitdepth: int = 8) -> np.ndarray:
    """spec 8.6.4: two 1-D inverse transforms with intermediate clipping.
    d is the dequantized coefficient array d[y][x] (row=y). Returns residual
    r[y][x] int32."""
    n = 1 << log2_size
    mat = DST4 if is_dst else dct_matrix(n)
    shift1 = 7
    shift2 = 20 - bitdepth
    # first stage: vertical (columns): e[x][j] = sum_k mat[k][j] * d[k][x]
    # spec: e = M^T * d (columns transformed)
    e = mat.T.astype(np.int64) @ d.astype(np.int64)
    e = np.clip((e + (1 << (shift1 - 1))) >> shift1, -32768, 32767)
    # second stage: horizontal (rows)
    r = e @ mat.astype(np.int64)
    r = (r + (1 << (shift2 - 1))) >> shift2
    return np.clip(r, -32768, 32767).astype(np.int32)


def transform_skip_residual(d: np.ndarray, log2_size: int, bitdepth: int = 8,
                            rdpcm: int = 0) -> np.ndarray:
    """spec 8.6.4.1 transform-skip: r = (d << tsShift + rnd) >> bdShift with
    tsShift = 5 + log2 (reference transform_skip_residual_fallback,
    fallback-dct.cc:79-90). rdpcm 1/2 accumulates the scaled values along
    rows/columns (rdpcm_h/v_fallback, fallback-dct.cc:185-213)."""
    ts_shift = 5 + log2_size
    shift = 20 - bitdepth
    r = (d.astype(np.int64) << ts_shift)
    r = (r + (1 << (shift - 1))) >> shift
    if rdpcm == 1:       # horizontal: accumulate along x
        return np.cumsum(r, axis=1).astype(np.int32)
    if rdpcm == 2:       # vertical: accumulate along y
        return np.cumsum(r, axis=0).astype(np.int32)
    return np.clip(r, -32768, 32767).astype(np.int32)


def scale_and_inv_transform(coeffs: np.ndarray, qp: int, log2_size: int,
                            is_dst: bool, transform_skip: bool, tq_bypass: bool,
                            bitdepth: int = 8, scaling_matrix=None,
                            scaling_dc=None, rdpcm: int = 0,
                            rotate: bool = False) -> np.ndarray:
    """Full residual path for one TU (counterpart of scale_coefficients_internal,
    /root/reference/libde265/transform.cc:352-625).

    Range-extension tools: rdpcm (0 none / 1 horizontal / 2 vertical)
    accumulates residual differences (transform.cc:418-429,549-560);
    rotate flips the 4x4 block 180 degrees before the skip/bypass stage
    (transform_skip_rotation, transform.cc:395-408,548-551)."""
    if tq_bypass:
        r = coeffs.astype(np.int64)
        if rotate:
            r = r[::-1, ::-1]
        if rdpcm == 1:
            r = np.cumsum(r, axis=1)
        elif rdpcm == 2:
            r = np.cumsum(r, axis=0)
        return r.astype(np.int32)
    d = dequant(coeffs, qp, log2_size, bitdepth, scaling_matrix, scaling_dc)
    if transform_skip:
        if rotate:
            d = d[::-1, ::-1]
        return transform_skip_residual(d, log2_size, bitdepth, rdpcm)
    return inv_transform(d, log2_size, is_dst, bitdepth)
