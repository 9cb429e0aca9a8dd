"""Batched dequant + inverse transform (JAX/XLA), bit-exact integer.

TUs are bucketed by size class (4/8/16/32 — exactly the size classes of the
reference's acceleration table, acceleration.h:29-201) and processed as
(N, n, n) int32 batches. The 1-D transforms are int32 x int32 matmuls with
int32 accumulation (exact).

All rounding/shift semantics follow spec 8.6.3/8.6.4 exactly (same math as
ops/transform_ref.py, which is the differential-test oracle).
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .transform_ref import dct_matrix, DST4, LEVEL_SCALE

LEVEL_SCALE_ARR = np.array(LEVEL_SCALE, np.int32)


def _matrices(log2, is_dst):
    if is_dst:
        return np.asarray(DST4, np.int32)
    return np.asarray(dct_matrix(1 << log2), np.int32)


@partial(jax.jit, static_argnames=("log2", "bitdepth"))
def dequant_batch(coeffs, qp, log2, bitdepth=8):
    """coeffs: (N,n,n) int32; qp: (N,) int32. Returns (N,n,n) int32."""
    bd_shift = bitdepth + log2 - 5
    ls = jnp.asarray(LEVEL_SCALE_ARR)
    factor = (16 * ls[qp % 6]) << (qp // 6)  # (N,)
    d = (coeffs.astype(jnp.int64) * factor[:, None, None].astype(jnp.int64)
         + (1 << (bd_shift - 1))) >> bd_shift
    return jnp.clip(d, -32768, 32767).astype(jnp.int32)


@partial(jax.jit, static_argnames=("log2", "is_dst", "bitdepth"))
def inv_transform_batch(d, log2, is_dst, bitdepth=8):
    """(N,n,n) int32 dequantized coeffs -> (N,n,n) int32 residual."""
    mat = jnp.asarray(_matrices(log2, is_dst))
    shift2 = 20 - bitdepth
    # stage 1 (vertical): e = M^T @ d, clip to 16 bit after >>7
    e = jnp.einsum("kj,nkx->njx", mat, d,
                   preferred_element_type=jnp.int32)
    e = jnp.clip((e + 64) >> 7, -32768, 32767)
    # stage 2 (horizontal): r = e @ M
    r = jnp.einsum("njx,xi->nji", e, mat, preferred_element_type=jnp.int32)
    r = (r + (1 << (shift2 - 1))) >> shift2
    return jnp.clip(r, -32768, 32767).astype(jnp.int32)


@partial(jax.jit, static_argnames=("log2", "bitdepth"))
def transform_skip_batch(d, log2, bitdepth=8):
    shift = 20 - bitdepth
    r = (d.astype(jnp.int32) << 7)
    r = (r + (1 << (shift - 1))) >> shift
    return jnp.clip(r, -32768, 32767).astype(jnp.int32)


@partial(jax.jit, static_argnames=("log2", "bitdepth"))
def dequant_batch_sl(coeffs, qp, smat, log2, bitdepth=8):
    """Scaling-list dequant (spec 8.6.3 with m[x][y]; reference
    transform.cc:477-510). smat: (n,n) or (N,n,n) int32 scale matrix
    (DC coefficient already substituted on host)."""
    bd_shift = bitdepth + log2 - 5
    ls = jnp.asarray(LEVEL_SCALE_ARR)[qp % 6]
    if smat.ndim == 2:
        smat = smat[None]
    prod = coeffs.astype(jnp.int64) * smat.astype(jnp.int64) * \
        ls[:, None, None].astype(jnp.int64)
    d = (jnp.left_shift(prod, (qp // 6)[:, None, None].astype(jnp.int64))
         + (1 << (bd_shift - 1))) >> bd_shift
    return jnp.clip(d, -32768, 32767).astype(jnp.int32)


@partial(jax.jit, static_argnames=("log2", "is_dst", "bitdepth"))
def residual_batch(coeffs, qp, log2, is_dst, bitdepth=8):
    """Fused dequant + inverse transform for one TU size bucket."""
    d = dequant_batch(coeffs, qp, log2, bitdepth)
    return inv_transform_batch(d, log2, is_dst, bitdepth)


@partial(jax.jit, static_argnames=("log2", "is_dst", "bitdepth"))
def residual_batch_sl(coeffs, qp, smat, log2, is_dst, bitdepth=8):
    """residual_batch with a scaling-list dequant."""
    d = dequant_batch_sl(coeffs, qp, smat, log2, bitdepth)
    return inv_transform_batch(d, log2, is_dst, bitdepth)


