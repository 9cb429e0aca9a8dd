"""Class-masked matmul motion compensation: the tap passes as matmuls.

The elementwise form of the two shifted-tap passes
(mc_tile_jax._luma_pred_tile) is 22 shifted int32 multiply-adds over
(N,80/64) lanes. But within one (fractional-phase, tile-misalignment)
CLASS the shifted tap vector is a CONSTANT, so each pass is a per-row
matmul with one of <=16 (luma) / <=32 (chroma) small banded
matrices.

Rows are routed to their class matrix by MASKING, not sorting: one
stacked matmul (N,K)@(K,J*n_cls) computes every populated class's
result for every row, and a one-hot multiply-reduce keeps each row's
own class (_class_pass), trading redundant matmul FLOPs and one extra
(N, J*n_cls) f32 round-trip for the row scatter a class sort would
need. Streams with a single populated class (constant-phase motion)
skip the mask entirely.

Pipeline (per prediction list):
  1. classes: hcls = (mvx&3)*4 + dx, vcls = (mvy&3)*4 + dy  (16 each
     for luma; 8 eighth-pel phases x 4 misalignments = 32 for chroma),
     where dx/dy is the window's misalignment inside its stride-4 tile
     (mc_tile_jax geometry, incl. the edge clamp).
  2. ONE (N,) table-row gather in natural block order.
  3. h-pass via _class_pass. bf16 x bf16 -> f32 for 8-bit: every
     sample < 2^8 and |tap| <= 58 is exact in bf16, each product is
     exact in the f32 accumulator, and |tmp| <= 255*112 = 28560 < 2^24
     so the sum is exact (the one-hot reduce adds exact f32 values).
     f32 x f32 (HIGHEST precision: >= bf16x3 passes — exact because
     the tap operand has no low bf16 half and samples fit 16 mantissa
     bits) for 10-bit.
  4. v-pass via _class_pass in f32 (|out| <= 28560*112 = 3.2M < 2^24:
     exact), >> 6 in int32 (f32->int32 cast is exact: integers).

The populated class-id sets are STATIC per stream (ProgramCfg.mc_caps
/ mc_caps_c, from stream_cfg's numpy run of the same class
derivation over every frame's mv grid), so the stacked matrices are
compile-time constants. A row whose class is unpopulated (possible
only for non-inter blocks, whose grid mv is arbitrary) reduces to 0
and is masked off by the caller's inter mask.

Reference kernels: qpel SSE paths acceleration.h:29-201, mc_luma
motion.cc:49-170; epel paths acceleration.h:115-201, mc_chroma
motion.cc:172-223.
"""
import numpy as np
import jax
import jax.numpy as jnp

from .mc_tile_jax import TH_Y

NCLS = 16


def _mk_class_mats():
    """MH[p]: (256,80) h-pass matrix, tmp[j*16+r] = sum_c win[c*16+r] *
    TH_Y[p][c-j].  MV[p]: (80,16) v-pass matrix, out[j*4+i] =
    sum_k tmp[j*16+k] * TH_Y[p][k-i]."""
    MH = np.zeros((NCLS, 256, 80), np.int32)
    MV = np.zeros((NCLS, 80, 16), np.int32)
    for p in range(NCLS):
        for j in range(5):
            for r in range(16):
                for u in range(11):
                    MH[p, (u + j) * 16 + r, j * 16 + r] = TH_Y[p, u]
        for j in range(4):
            for i in range(4):
                for u in range(11):
                    MV[p, j * 16 + (i + u), j * 4 + i] = TH_Y[p, u]
    return MH, MV


MH_NP, MV_NP = _mk_class_mats()


def luma_geom(xp, bx, by, mvx, mvy, slot, nty, ntx, H, W):
    """Shared device/host geometry: table row index + h/v class per 4x4
    block. xp = jnp (trace) or np (stream_cfg capacity analysis) — the
    two MUST agree or the static capacities under-provision."""
    x0 = xp.clip(bx + (mvx >> 2) - 3, -14, W + 1)
    y0 = xp.clip(by + (mvy >> 2) - 3, -14, H + 1)
    tx = (x0 + 16) >> 2
    ty = (y0 + 16) >> 2
    dx = (x0 + 16) & 3
    dy = (y0 + 16) & 3
    idx = (slot * nty + ty) * ntx + tx
    hcls = (mvx & 3) * 4 + dx
    vcls = (mvy & 3) * 4 + dy
    return idx, hcls, vcls


_BXBY_CACHE = {}


def _block_xy(H, W):
    """(bx, by) int32 luma block origins in device raster order, cached
    per resolution (stream_cfg calls the class counters per frame)."""
    key = (H, W)
    hit = _BXBY_CACHE.get(key)
    if hit is None:
        n_bx = W // 4
        N = n_bx * (H // 4)
        i = np.arange(N, dtype=np.int32)
        hit = _BXBY_CACHE[key] = ((i % n_bx) * 4, (i // n_bx) * 4)
    return hit


def luma_class_counts(mv_lane, H, W):
    """Host: (N,2) int (mvx,mvy) for ONE lane in device block-raster
    order -> ((16,) h-class counts, (16,) v-class counts) (numpy).
    Classes-only re-derivation of luma_geom (same clip geometry; the
    table row index is not needed for capacity analysis)."""
    bx, by = _block_xy(H, W)
    mvx = mv_lane[:, 0].astype(np.int32)
    mvy = mv_lane[:, 1].astype(np.int32)
    x0 = np.clip(bx + (mvx >> 2) - 3, -14, W + 1)
    y0 = np.clip(by + (mvy >> 2) - 3, -14, H + 1)
    hcls = (mvx & 3) * 4 + ((x0 + 16) & 3)
    vcls = (mvy & 3) * 4 + ((y0 + 16) & 3)
    return (np.bincount(hcls, minlength=NCLS),
            np.bincount(vcls, minlength=NCLS))


def caps_from_counts(hmax, vmax):
    """Per-class max counts (h and v) -> hashable cfg class sets: the
    tuples of POPULATED class ids. (The name is historical — an earlier
    sorted design carried padded per-class capacities here; the masked
    design only needs to know which class matrices to stack.)"""
    return (tuple(i for i, h in enumerate(hmax) if h),
            tuple(i for i, v in enumerate(vmax) if v))


def _class_pass(x, cls, ids, mats_np, prec):
    """Per-row matmul x[n] @ mats[cls[n]], cls restricted to the static
    id set `ids`: ONE stacked matmul (N,K)@(K,J*n_ids) + one-hot
    reduce. Rows whose class is outside `ids` produce 0. x: (N,K) bf16
    or f32; returns (N,J) f32 (exact — see module docstring)."""
    n_ids = len(ids)
    J = mats_np.shape[2]
    if n_ids == 1:
        return jnp.matmul(x, jnp.asarray(mats_np[ids[0]], x.dtype),
                          preferred_element_type=jnp.float32,
                          precision=prec)
    stack = np.concatenate([mats_np[h] for h in ids], axis=1)
    tall = jnp.matmul(x, jnp.asarray(stack, x.dtype),
                      preferred_element_type=jnp.float32,
                      precision=prec)                 # (N, J*n_ids)
    oh = (cls[:, None] == jnp.asarray(ids, jnp.int32)) \
        .astype(jnp.float32)                          # (N, n_ids)
    return (tall.reshape(-1, n_ids, J) * oh[:, :, None]).sum(axis=1)


def mc_luma_mxu(table_y, nty, ntx, bx, by, mvx, mvy, slot, H, W, shift1,
                caps, bitdepth=8):
    """One list's luma prediction for all N 4x4 blocks: (N,4,4) int32
    (14-bit scale). Drop-in for mc_tile_jax._luma_pred_tile; caps =
    (h class ids, v class ids) from caps_from_counts via
    ProgramCfg.mc_caps."""
    hids, vids = caps
    idx, hcls, vcls = luma_geom(jnp, bx, by, mvx, mvy, slot, nty, ntx, H, W)
    in_dt = jnp.bfloat16 if bitdepth == 8 else jnp.float32
    prec = jax.lax.Precision.HIGHEST

    win = table_y[idx].astype(in_dt)                      # (N, 256)
    tmp = _class_pass(win, hcls.astype(jnp.int32), hids, MH_NP, prec)
    if shift1:
        tmp = (tmp.astype(jnp.int32) >> shift1).astype(jnp.float32)
    out = _class_pass(tmp, vcls.astype(jnp.int32), vids,
                      MV_NP.astype(np.float32), prec)     # (N, 16)
    out = out.astype(jnp.int32) >> 6
    # lane j*4+i -> (N, i, j)
    return out.reshape(-1, 4, 4).transpose(0, 2, 1)


# ------------------------------------------------------------- chroma
# Same class-sorted design for the 2x2 chroma blocks, with two twists:
# 32 classes (8 eighth-pel phases x 4 tile misalignments) and BOTH
# planes ride one pipeline: Cb|Cr windows concatenate on lanes to a
# (., 128) block and the per-class matrices are block-diagonal pairs,
# so one h-matmul (c,128)@(128,32) and one v-matmul (c,32)@(32,8)
# produce both planes (the class geometry is identical for Cb and Cr).
# Reference: epel SSE paths acceleration.h:115-201, mc_chroma
# motion.cc:172-223.
from .mc_tile_jax import TH_C

NCLS_C = 32


def _mk_class_mats_c():
    """MHC2[p]: (128,32) h-pass, per plane tmp[j*8+r] =
    sum_u win[(u+j)*8+r] * TH_C[p][u] (j<2, r<8).  MVC2[p]: (32,8)
    v-pass, per plane out[j*2+i] = sum_u tmp[j*8+(i+u)] * TH_C[p][u]
    (j<2, i<2). Both are two copies of the single-plane matrix on the
    block diagonal."""
    MHC = np.zeros((NCLS_C, 64, 16), np.int32)
    MVC = np.zeros((NCLS_C, 16, 4), np.int32)
    for p in range(NCLS_C):
        for j in range(2):
            for r in range(8):
                for u in range(7):
                    MHC[p, (u + j) * 8 + r, j * 8 + r] = TH_C[p, u]
        for j in range(2):
            for i in range(2):
                for u in range(7):
                    MVC[p, j * 8 + (i + u), j * 2 + i] = TH_C[p, u]
    MHC2 = np.zeros((NCLS_C, 128, 32), np.int32)
    MVC2 = np.zeros((NCLS_C, 32, 8), np.int32)
    MHC2[:, :64, :16] = MHC
    MHC2[:, 64:, 16:] = MHC
    MVC2[:, :16, :4] = MVC
    MVC2[:, 16:, 4:] = MVC
    return MHC2, MVC2


MHC2_NP, MVC2_NP = _mk_class_mats_c()


def chroma_geom(xp, bx, by, mvx, mvy, slot, nty, ntx, Hc, Wc):
    """Table row index + h/v class per 2x2 chroma block; mirrors
    mc_tile_jax._chroma_pred_tile's window geometry. bx/by are LUMA
    block origins (as in mc_frame_tile)."""
    x0 = xp.clip((bx >> 1) + (mvx >> 3) - 1, -7, Wc + 1)
    y0 = xp.clip((by >> 1) + (mvy >> 3) - 1, -7, Hc + 1)
    tx = (x0 + 8) >> 2
    ty = (y0 + 8) >> 2
    dx = (x0 + 8) & 3
    dy = (y0 + 8) & 3
    idx = (slot * nty + ty) * ntx + tx
    hcls = (mvx & 7) * 4 + dx
    vcls = (mvy & 7) * 4 + dy
    return idx, hcls, vcls


def chroma_class_counts(mv_lane, H, W):
    """Host: (N,2) (mvx,mvy) for ONE lane, luma geometry H/W ->
    ((32,) h counts, (32,) v counts)."""
    bx, by = _block_xy(H, W)
    Hc, Wc = H // 2, W // 2
    mvx = mv_lane[:, 0].astype(np.int32)
    mvy = mv_lane[:, 1].astype(np.int32)
    x0 = np.clip((bx >> 1) + (mvx >> 3) - 1, -7, Wc + 1)
    y0 = np.clip((by >> 1) + (mvy >> 3) - 1, -7, Hc + 1)
    hcls = (mvx & 7) * 4 + ((x0 + 8) & 3)
    vcls = (mvy & 7) * 4 + ((y0 + 8) & 3)
    return (np.bincount(hcls, minlength=NCLS_C),
            np.bincount(vcls, minlength=NCLS_C))


def mc_chroma_mxu(table_c2, nty, ntx, bx, by, mvx, mvy, slot,
                  Hc, Wc, shift1, caps, bitdepth=8):
    """One list's Cb AND Cr predictions for all N 2x2 blocks:
    ((N,2,2), (N,2,2)) int32 (14-bit scale). table_c2 carries the
    interleaved [Cb 64 | Cr 64] rows, so both planes' windows arrive
    with ONE row gather. Drop-in pair for two
    mc_tile_jax._chroma_pred_tile calls; caps = (h class ids, v class
    ids) = ProgramCfg.mc_caps_c."""
    hids, vids = caps
    idx, hcls, vcls = chroma_geom(jnp, bx, by, mvx, mvy, slot, nty, ntx,
                                  Hc, Wc)
    in_dt = jnp.bfloat16 if bitdepth == 8 else jnp.float32
    prec = jax.lax.Precision.HIGHEST

    win = table_c2[idx].astype(in_dt)                     # (N, 128)
    tmp = _class_pass(win, hcls.astype(jnp.int32), hids, MHC2_NP, prec)
    if shift1:
        tmp = (tmp.astype(jnp.int32) >> shift1).astype(jnp.float32)
    g = _class_pass(tmp, vcls.astype(jnp.int32), vids,
                    MVC2_NP.astype(np.float32), prec)     # (N, 8)
    g = g.astype(jnp.int32) >> 6
    # plane lanes [4*pl + j*2 + i] -> (N, i, j)
    cb = g[:, :4].reshape(-1, 2, 2).transpose(0, 2, 1)
    cr = g[:, 4:].reshape(-1, 2, 2).transpose(0, 2, 1)
    return cb, cr
