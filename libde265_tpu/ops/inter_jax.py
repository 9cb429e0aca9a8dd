"""Batched inter prediction (MC) on the device — bit-exact (spec 8.5.3.3).

MC path hierarchy (consolidated round 2): mc_tile_jax.py is the
PRODUCTION path (tile-table gather + folded-phase taps, used by the fused
frame program); inter_dense_jax.py is its dense per-4x4 oracle and the
hybrid device path's MC; THIS module supplies the shared tap tables and
the per-(w,h)-bucket kernels kept for the acceleration_speed differential
harness — it is not on the decode path.

Design: PUs are bucketed by (w, h); each bucket is one batched
gather + two separable tap passes. Integer/fractional phases are unified by
using impulse taps ([...64...]) for integer positions — algebraically
identical to the spec's special cases, so ONE kernel covers all 16 qpel /
64 epel phases (the reference needs a 4x4 function table per phase,
acceleration.h qpel[4][4]).

Reference pictures are stacked into one (R, H, W) tensor; each PU row indexes
its reference — the device-side mirror of the DPB.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .inter_ref import QPEL_FILTERS, EPEL_FILTERS

# tap tables with impulse row for phase 0
QPEL_TAPS = np.zeros((4, 8), np.int32)
QPEL_TAPS[0, 3] = 64
for ph, taps in QPEL_FILTERS.items():
    QPEL_TAPS[ph] = taps
EPEL_TAPS = np.zeros((8, 4), np.int32)
EPEL_TAPS[0, 1] = 64
for ph, taps in EPEL_FILTERS.items():
    EPEL_TAPS[ph] = taps


@partial(jax.jit, static_argnames=("w", "h", "bitdepth"))
def mc_luma_batch(refstack, ref_slot, xs, ys, fx, fy, w, h, bitdepth=8):
    """refstack (R,H,W) int32; per-PU integer position (xs,ys) (mv applied),
    fractional phases fx,fy in 0..3. Returns (N,h,w) int32 14-bit."""
    R, H, W = refstack.shape
    shift1 = min(4, bitdepth - 8)
    iy = jnp.clip(ys[:, None] + jnp.arange(-3, h + 4)[None, :], 0, H - 1)
    ix = jnp.clip(xs[:, None] + jnp.arange(-3, w + 4)[None, :], 0, W - 1)
    win = refstack[ref_slot[:, None, None], iy[:, :, None], ix[:, None, :]]
    taps_h = jnp.asarray(QPEL_TAPS)[fx]          # (N,8)
    taps_v = jnp.asarray(QPEL_TAPS)[fy]
    tmp = sum(taps_h[:, k, None, None] * win[:, :, k:k + w] for k in range(8))
    tmp = tmp >> shift1
    out = sum(taps_v[:, k, None, None] * tmp[:, k:k + h, :] for k in range(8))
    return out >> 6


@partial(jax.jit, static_argnames=("w", "h", "bitdepth"))
def mc_chroma_batch(refstack, ref_slot, xs, ys, fx, fy, w, h, bitdepth=8):
    """Chroma 4-tap, phases 0..7; coordinates in chroma samples."""
    R, H, W = refstack.shape
    shift1 = min(4, bitdepth - 8)
    iy = jnp.clip(ys[:, None] + jnp.arange(-1, h + 2)[None, :], 0, H - 1)
    ix = jnp.clip(xs[:, None] + jnp.arange(-1, w + 2)[None, :], 0, W - 1)
    win = refstack[ref_slot[:, None, None], iy[:, :, None], ix[:, None, :]]
    taps_h = jnp.asarray(EPEL_TAPS)[fx]
    taps_v = jnp.asarray(EPEL_TAPS)[fy]
    tmp = sum(taps_h[:, k, None, None] * win[:, :, k:k + w] for k in range(4))
    tmp = tmp >> shift1
    out = sum(taps_v[:, k, None, None] * tmp[:, k:k + h, :] for k in range(4))
    return out >> 6


@partial(jax.jit, static_argnames=("bitdepth",))
def combine_batch(p0, p1, has1, w0, o0, w1, o1, log2wd, explicit, bitdepth=8):
    """Weighted/default combine for a bucket (spec 8.5.3.3.4).
    p0/p1: (N,h,w) 14-bit; has1 (N,) bool; per-PU weights (N,)."""
    maxv = (1 << bitdepth) - 1
    shift = 14 - bitdepth
    # default
    bi = jnp.clip((p0 + p1 + (1 << shift)) >> (shift + 1), 0, maxv)
    uni = jnp.clip((p0 + (1 << (shift - 1))) >> shift, 0, maxv)
    dflt = jnp.where(has1[:, None, None], bi, uni)
    # explicit weighted
    l2 = log2wd[:, None, None]
    w0_ = w0[:, None, None]; o0_ = o0[:, None, None]
    w1_ = w1[:, None, None]; o1_ = o1[:, None, None]
    ebi = jnp.clip((p0 * w0_ + p1 * w1_ + ((o0_ + o1_ + 1) << l2)) >> (l2 + 1),
                   0, maxv)
    euni = jnp.clip(((p0 * w0_ + (1 << jnp.maximum(l2 - 1, 0)) *
                      (l2 >= 1)) >> l2) + o0_, 0, maxv)
    expl = jnp.where(has1[:, None, None], ebi, euni)
    return jnp.where(explicit[:, None, None], expl, dflt)
