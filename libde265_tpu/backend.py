"""Device backend: batched device-side frame reconstruction.

The serial front-end produces a FramePlan; this module packs its work lists
into dense, size-bucketed tensors (the batched mirror of the reference's
acceleration_functions dispatch by block size, acceleration.h:29-201) and runs
the pixel pipeline on device:

    residuals:  dequant + inverse DCT/DST per size class (int32, bit-exact)
    scatter:    TU residual blocks -> frame planes
    filters:    whole-frame deblock (V then H) + SAO

Intra prediction's sequential dependency is handled by wavefront levels (host
computes the level of each TU; device processes one level per step) — see
intra_wavefront.py. Inter MC is batched per PU size bucket.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .ops import transform_jax
from .plan import MODE_INTRA


SIZE_CLASSES = ((2, True), (2, False), (3, False), (4, False), (5, False))


def pack_tu_batches(plan, bitdepth=8):
    """Bucket TUs by (log2, is_dst); returns dict keyed by class with
    coeffs (N,n,n) int32, qp (N,), x (N,), y (N,), cidx (N,)."""
    buckets = {k: {"coeffs": [], "qp": [], "x": [], "y": [], "cidx": []}
               for k in SIZE_CLASSES}
    for tu in plan.tus:
        if tu.coeffs is None or tu.cidx < 0 or tu.tq_bypass or tu.transform_skip:
            continue
        is_dst = (tu.cidx == 0 and tu.log2 == 2 and tu.pred_mode == MODE_INTRA)
        b = buckets[(tu.log2, is_dst)]
        b["coeffs"].append(tu.coeffs)
        b["qp"].append(tu.qp)
        b["x"].append(tu.x)
        b["y"].append(tu.y)
        b["cidx"].append(tu.cidx)
    out = {}
    for k, b in buckets.items():
        if not b["coeffs"]:
            continue
        out[k] = {
            "coeffs": np.stack(b["coeffs"]).astype(np.int32),
            "qp": np.asarray(b["qp"], np.int32),
            "x": np.asarray(b["x"], np.int32),
            "y": np.asarray(b["y"], np.int32),
            "cidx": np.asarray(b["cidx"], np.int32),
        }
    return out


@partial(jax.jit, static_argnames=("log2", "is_dst", "bitdepth"))
def residual_batch_device(coeffs, qp, log2, is_dst, bitdepth=8):
    return transform_jax.residual_batch(coeffs, qp, log2, is_dst, bitdepth)


@partial(jax.jit, static_argnames=("log2", "maxv"))
def scatter_residuals(plane, res, xs, ys, log2, maxv):
    """plane (H,W) int32; res (N,n,n) at block-aligned (xs,ys): row-scatter
    into a slot table (TUs never overlap -> unique slots), reshape to a full
    residual plane, add+clip (one row scatter instead of an elementwise
    2-D scatter)."""
    H, W = plane.shape
    n = 1 << log2
    # CEIL lattice: plane dims need not be n-multiples (1080p with
    # 16/32 TUs); real TUs always fit inside, pad rows stay zero
    nrows, ncols = -(-H // n), -(-W // n)
    rows = res.reshape(res.shape[0], n * n)
    slots = (ys >> log2) * ncols + (xs >> log2)
    table = jnp.zeros((nrows * ncols, n * n), jnp.int32)
    table = table.at[slots].set(rows, unique_indices=True)
    rp = table.reshape(nrows, ncols, n, n).transpose(0, 2, 1, 3)
    return jnp.clip(plane + rp.reshape(nrows * n, ncols * n)[:H, :W], 0,
                    maxv)


def add_frame_residuals(planes_i32, batches, bitdepth=8):
    """Apply all bucketed residuals to [Y,Cb,Cr] int32 device planes."""
    maxv = (1 << bitdepth) - 1
    for (log2, is_dst), b in batches.items():
        res = residual_batch_device(jnp.asarray(b["coeffs"]),
                                    jnp.asarray(b["qp"]), log2, is_dst, bitdepth)
        for ci in range(3):
            sel = b["cidx"] == ci
            if not sel.any():
                continue
            planes_i32[ci] = scatter_residuals(
                planes_i32[ci], res[jnp.asarray(np.nonzero(sel)[0])],
                jnp.asarray(b["x"][sel]), jnp.asarray(b["y"][sel]), log2, maxv)
    return planes_i32


def reconstruct_frame_device(plan, dpb=None):
    """Device-side reconstruction for frames whose prediction is already in
    plan.planes (MC or intra done), applying residuals + loop filters.
    Bit-exact counterpart of reconstruct.reconstruct_frame's filter stages."""
    from .ops.deblock_jax import deblock_frame_jax
    from .ops.sao_jax import sao_frame_jax
    planes = plan.planes
    shs = plan.slice_headers or []
    if any(not sh.slice_deblocking_filter_disabled_flag for sh in shs):
        deblock_frame_jax(plan, planes)
    if any(sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag for sh in shs):
        planes = sao_frame_jax(plan, planes)
        plan.planes = planes
    return planes
