"""Tile-table motion compensation.

Instead of gathering an 11x11 window per 4x4 block with per-element
indices (ops/inter_dense_jax.py), gather ONE contiguous row of 256 from
a precomputed overlap-tile table, then apply the 8-tap
interpolation (reference kernels acceleration.h qpel[4][4]/epel,
motion.cc:49-278) as two batched matmuls whose matrices fold together the
fractional phase AND the window's misalignment within its tile.

Geometry (luma): every 11x11 qpel window is contained in the 16x16 tile
anchored at the 4-aligned floor of the window start, so a stride-4 table
of 16x16 tiles over the edge-padded plane serves every block with one
row-gather. Chroma: 5x5 epel windows in stride-4 8x8 tiles.

Edge handling: planes are edge-replication padded by 16 (luma) / 8
(chroma) and window starts clamped so far-out-of-range MVs land in the
replicated border — bit-exact with the spec's per-sample coordinate
Clip3 (motion.cc:69-98).

Everything here is jit-safe (static shapes per resolution + ref count).
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .inter_jax import QPEL_TAPS, EPEL_TAPS

PAD_Y = 16
PAD_C = 8


def n_tiles_y(H, W):
    """Luma tile-table grid for an (H, W) plane: (row count, column
    count). Window clamping keeps every gathered row index below it."""
    return (H + 20) // 4, (W + 20) // 4


def n_tiles_c(Hc, Wc):
    """Chroma tile-table grid for an (Hc, Wc) plane."""
    return (Hc + 12) // 4, (Wc + 12) // 4


def _mk_shift_tables():
    """Static (phase*4+misalign) -> shifted tap vectors.

    TH_Y[p*4+d][u] = QPEL_TAPS[p][u-d]  (u in 0..10; support d..d+7)
    TH_C[p*4+d][u] = EPEL_TAPS[p][u-d]  (u in 0..6;  support d..d+3)
    The filter then reads win[.., u+j] * TH[.., u] — pure vector
    multiply-adds, no per-block matrices (XLA batches tiny matmuls badly).
    """
    ty = np.zeros((16, 11), np.int32)
    for p in range(4):
        for d in range(4):
            for u in range(11):
                if 0 <= u - d < 8:
                    ty[p * 4 + d, u] = QPEL_TAPS[p][u - d]
    tc = np.zeros((32, 7), np.int32)
    for p in range(8):
        for d in range(4):
            for u in range(7):
                if 0 <= u - d < 4:
                    tc[p * 4 + d, u] = EPEL_TAPS[p][u - d]
    return ty, tc


TH_Y, TH_C = _mk_shift_tables()


def pad_plane(p, pad):
    """Edge-replicate pad on all sides (device op)."""
    return jnp.pad(p, ((pad, pad), (pad, pad)), mode="edge")


def build_tile_table_y(padded, out_dtype=jnp.int16):
    """padded: (R, H+32, W+32) -> (R*nty*ntx, 256) stride-4 16x16
    tiles, element [c*16 + r] = tile[row r, col c] (column-major within the
    tile). (nty, ntx) = n_tiles_y(H, W). out_dtype uint8 for 8-bit
    streams halves the table (the decode path's largest device
    tenant)."""
    R, Hp, Wp = padded.shape
    nty, ntx = (Hp - 12) // 4, (Wp - 12) // 4
    padded = padded.astype(out_dtype)
    rows = jnp.concatenate(
        [padded[:, 4 * s:4 * s + 4 * nty, :].reshape(R, nty, 4, Wp)
         for s in range(4)], axis=2)                        # (R,nty,16,Wp)
    tiles = jnp.concatenate(
        [rows[:, :, :, 4 * s:4 * s + 4 * ntx].reshape(R, nty, 16, ntx, 4)
         for s in range(4)], axis=4)                        # (R,nty,16r,ntx,16c)
    t5 = tiles.transpose(0, 1, 3, 4, 2)                     # (R,nty,ntx,c,r)
    return t5.reshape(R * nty * ntx, 256)


def build_tile_table_c(padded, out_dtype=jnp.int16):
    """padded: (R, Hc+16, Wc+16) -> (R*nty*ntx, 64) stride-4 8x8 tiles,
    element [c*8 + r]. (nty, ntx) = n_tiles_c(Hc, Wc)."""
    R, Hp, Wp = padded.shape
    nty, ntx = (Hp - 4) // 4, (Wp - 4) // 4
    padded = padded.astype(out_dtype)
    rows = jnp.concatenate(
        [padded[:, 4 * s:4 * s + 4 * nty, :].reshape(R, nty, 4, Wp)
         for s in range(2)], axis=2)                        # (R,nty,8,Wp)
    tiles = jnp.concatenate(
        [rows[:, :, :, 4 * s:4 * s + 4 * ntx].reshape(R, nty, 8, ntx, 4)
         for s in range(2)], axis=4)                        # (R,nty,8r,ntx,8c)
    t5 = tiles.transpose(0, 1, 3, 4, 2)                     # (R,nty,ntx,c,r)
    return t5.reshape(R * nty * ntx, 64)


def _pad_refs(refs_y, refs_cb, refs_cr):
    py = jnp.pad(refs_y.astype(jnp.int16),
                 ((0, 0), (PAD_Y, PAD_Y), (PAD_Y, PAD_Y)), mode="edge")
    pcb = jnp.pad(refs_cb.astype(jnp.int16),
                  ((0, 0), (PAD_C, PAD_C), (PAD_C, PAD_C)), mode="edge")
    pcr = jnp.pad(refs_cr.astype(jnp.int16),
                  ((0, 0), (PAD_C, PAD_C), (PAD_C, PAD_C)), mode="edge")
    return py, pcb, pcr


def build_tables(refs_y, refs_cb, refs_cr, bitdepth=8):
    """refs_*: (R,H,W)/(R,Hc,Wc) integer stacks -> (ty, tc2) tile tables
    (device), uint8 for 8-bit streams / int16 otherwise. tc2 interleaves
    both chroma planes per row ([Cb 64 | Cr 64]): chroma MC gathers BOTH
    planes' windows with ONE 128-byte-row gather (identical geometry)."""
    dt = jnp.uint8 if bitdepth <= 8 else jnp.int16
    py, pcb, pcr = _pad_refs(refs_y, refs_cb, refs_cr)
    ty = build_tile_table_y(py, dt)
    tcb = build_tile_table_c(pcb, dt)
    tcr = build_tile_table_c(pcr, dt)
    return ty, jnp.concatenate([tcb, tcr], axis=1)


def _luma_pred_tile(table_y, nty, ntx, bx, by, mvx, mvy, slot, H, W, shift1):
    """One list's luma prediction for all N 4x4 blocks: (N,4,4) int32
    (14-bit intermediate scale).

    The filter works on the FLAT (N,256) gathered rows with static
    128/64-lane slices: row element c*16+r, so win[:, 16u:16u+128] puts
    win[(u+j)*16+r] at lane j*16+r — both tap passes become aligned
    elementwise multiply-adds with zero relayout."""
    x0 = jnp.clip(bx + (mvx >> 2) - 3, -14, W + 1)
    y0 = jnp.clip(by + (mvy >> 2) - 3, -14, H + 1)
    tx = (x0 + 16) >> 2
    ty = (y0 + 16) >> 2
    dx = (x0 + 16) & 3
    dy = (y0 + 16) & 3
    idx = (slot * nty + ty) * ntx + tx
    from .lut import take_rows_small
    th = take_rows_small(TH_Y, (mvx & 3) * 4 + dx)          # (N,11)
    tv = take_rows_small(TH_Y, (mvy & 3) * 4 + dy)          # (N,11)
    win = table_y[idx]                          # (N, 256) i16, [c*16+r]
    # horizontal: lane j*16+r of tmp = sum_u win[(u+j)*16+r] * th[u]
    # (80 lanes: the vertical pass reads tmp lanes up to 10+63=73, and
    # 16*10+79=239 keeps every u-slice inside the 256-wide row)
    tmp = sum(win[:, 16 * u:16 * u + 80].astype(jnp.int32) * th[:, u, None]
              for u in range(11)) >> shift1               # (N,80)
    # vertical: lane j*16+i of out = sum_u tmp[j*16+(i+u)] * tv[u]
    # (i<4, u<11 -> i+u<=13<16: no cross-column contamination)
    out = sum(tmp[:, u:u + 64] * tv[:, u, None]
              for u in range(11)) >> 6                    # (N,64)
    # lane j*16+i -> (N, i, j)
    return out.reshape(-1, 4, 16)[:, :, :4].transpose(0, 2, 1)


def _chroma_pred_tile(table_c, nty, ntx, bx, by, mvx, mvy, slot, Hc, Wc,
                      shift1):
    """One list's chroma prediction for all N 2x2 blocks: (N,2,2) int32."""
    x0 = jnp.clip((bx >> 1) + (mvx >> 3) - 1, -7, Wc + 1)
    y0 = jnp.clip((by >> 1) + (mvy >> 3) - 1, -7, Hc + 1)
    tx = (x0 + 8) >> 2
    ty = (y0 + 8) >> 2
    dx = (x0 + 8) & 3
    dy = (y0 + 8) & 3
    idx = (slot * nty + ty) * ntx + tx
    from .lut import take_rows_small
    th = take_rows_small(TH_C, (mvx & 7) * 4 + dx)          # (N,7)
    tv = take_rows_small(TH_C, (mvy & 7) * 4 + dy)
    win = table_c[idx]                          # (N, 64) i16, [c*8+r]
    # flat-lane taps (see _luma_pred_tile): lane j*8+r, j<2 needed
    tmp = sum(win[:, 8 * u:8 * u + 16].astype(jnp.int32) * th[:, u, None]
              for u in range(7)) >> shift1                # (N,16)
    # i<2, u<7 -> i+u<=7: stays within the 8-row column group; only lanes
    # {0,1,8,9} (= j*8+i) are consumed, so a 10-lane window keeps every
    # u-slice inside tmp's 16 lanes
    out = sum(tmp[:, u:u + 10] * tv[:, u, None]
              for u in range(7)) >> 6                     # (N,10)
    # lanes j*8+i -> (N, i, j)
    return jnp.stack([out[:, 0:2], out[:, 8:10]], axis=2)


def mc_frame_tile(tables, dims, mv, slot, pf, wts, ex, bitdepth=8,
                  strip=None, x0=0, bi=True,
                  mc_caps=None, mc_caps_c=None, luma_only=False,
                  weighted=True):
    """Motion-compensate every 4x4 block of a frame from tile tables.

    tables : (table_y, table_c2) from build_tables (tc2 rows
             interleave [Cb 64 | Cr 64])
    dims   : (H, W) static python ints — the REFERENCE frame geometry
    mv     : (N,2,2) int32 qpel MVs per block per lane
    slot   : (N,2) int32 ref slot per lane
    pf     : (N,2) int32 pred flags (lane 0 always set for inter blocks)
    wts    : (N,3,5) int32 (w0,o0,w1,o1,log2Wd) per plane; ex: (N,) bool
    strip  : optional output strip width Ws (static): the N blocks cover
             a (H, Ws) strip whose global x origin is x0 (traced) — the
             tile-sharded path; default full frame.
    Returns [Y,Cb,Cr] dense int32 planes (every block predicted; caller
    masks non-inter regions).
    """
    H, W = dims
    table_y, table_c2 = tables
    table_cb, table_cr = table_c2[:, :64], table_c2[:, 64:]
    nty, ntx = n_tiles_y(H, W)
    Hc, Wc = H // 2, W // 2
    ntyc, ntxc = n_tiles_c(Hc, Wc)
    n_by = H // 4
    n_bx = (W if strip is None else strip) // 4
    N = n_by * n_bx
    bx = (jnp.arange(N, dtype=jnp.int32) % n_bx) * 4 + x0
    by = (jnp.arange(N, dtype=jnp.int32) // n_bx) * 4
    shift1 = min(4, bitdepth - 8)
    maxv = (1 << bitdepth) - 1
    shift = 14 - bitdepth

    def lane(l):
        return mv[:, l, 0], mv[:, l, 1], slot[:, l]

    mvx0, mvy0, s0 = lane(0)
    mvx1, mvy1, s1 = lane(1)
    if mc_caps:
        # class-masked matmul tap passes (ops/mc_mxu_jax.py); needs
        # static per-class capacities from the stream's plan analysis
        # (full-frame only)
        from .mc_mxu_jax import mc_luma_mxu
        y0p = mc_luma_mxu(table_y, nty, ntx, bx, by, mvx0, mvy0, s0, H, W,
                          shift1, mc_caps, bitdepth)
        y1p = mc_luma_mxu(table_y, nty, ntx, bx, by, mvx1, mvy1, s1, H, W,
                          shift1, mc_caps, bitdepth) if bi else None
    else:
        y0p = _luma_pred_tile(table_y, nty, ntx, bx, by, mvx0, mvy0, s0,
                              H, W, shift1)
        y1p = _luma_pred_tile(table_y, nty, ntx, bx, by, mvx1, mvy1, s1,
                              H, W, shift1) if bi else None
    # ---- plane-space combine: per-block tensors relayout to raster
    # planes BEFORE the uni/bi/weighted math, so the elementwise ops run
    # on wide (H,W) planes instead of minor dims of 4/2.
    def to_plane(p, s):
        return p.reshape(n_by, n_bx, s, s).transpose(0, 2, 1, 3) \
                .reshape(n_by * s, n_bx * s)

    def expand(a, s):
        g = a.reshape(n_by, n_bx)
        return jnp.broadcast_to(g[:, None, :, None],
                                (n_by, s, n_bx, s)) \
            .reshape(n_by * s, n_bx * s)

    def combine_plane(p0, p1, s, ci):
        P0 = to_plane(p0, s)
        P1 = to_plane(p1, s) if p1 is not None else None
        uni = jnp.clip((P0 + (1 << (shift - 1))) >> shift, 0, maxv)
        if P1 is None:
            dflt = uni
        else:
            has1 = expand(pf[:, 0] * pf[:, 1], s) != 0
            bi_ = jnp.clip((P0 + P1 + (1 << shift)) >> (shift + 1), 0, maxv)
            dflt = jnp.where(has1, bi_, uni)
        if not weighted:
            return dflt
        w0 = expand(wts[:, ci, 0], s)
        o0 = expand(wts[:, ci, 1], s)
        l2 = expand(wts[:, ci, 4], s)
        euni = jnp.clip(((P0 * w0 + (1 << jnp.maximum(l2 - 1, 0)) *
                          (l2 >= 1)) >> l2) + o0, 0, maxv)
        exm = expand(ex.astype(jnp.int32), s) != 0
        if P1 is None:
            return jnp.where(exm, euni, uni)
        w1 = expand(wts[:, ci, 2], s)
        o1 = expand(wts[:, ci, 3], s)
        ebi = jnp.clip((P0 * w0 + P1 * w1 + ((o0 + o1 + 1) << l2))
                       >> (l2 + 1), 0, maxv)
        return jnp.where(exm, jnp.where(has1, ebi, euni), dflt)

    Wo = n_bx * 4
    planes = [combine_plane(y0p, y1p, 4, 0)]
    if luma_only:                      # profiling ablation only
        z = jnp.zeros((Hc, Wo // 2), jnp.int32)
        return planes + [z, z]
    if mc_caps_c:
        # one class-masked matmul pipeline yields BOTH planes per lane,
        # gathering the interleaved Cb|Cr rows once
        from .mc_mxu_jax import mc_chroma_mxu
        cb0, cr0 = mc_chroma_mxu(table_c2, ntyc, ntxc, bx, by,
                                 mvx0, mvy0, s0, Hc, Wc, shift1,
                                 mc_caps_c, bitdepth)
        cb1, cr1 = mc_chroma_mxu(table_c2, ntyc, ntxc, bx, by,
                                 mvx1, mvy1, s1, Hc, Wc, shift1,
                                 mc_caps_c, bitdepth) if bi else (None,
                                                                  None)
        planes.append(combine_plane(cb0, cb1, 2, 1))
        planes.append(combine_plane(cr0, cr1, 2, 2))
        return planes
    for ci, tab in ((1, table_cb), (2, table_cr)):
        c0 = _chroma_pred_tile(tab, ntyc, ntxc, bx, by, mvx0, mvy0, s0,
                               Hc, Wc, shift1)
        c1 = _chroma_pred_tile(tab, ntyc, ntxc, bx, by, mvx1, mvy1, s1,
                               Hc, Wc, shift1) if bi else None
        planes.append(combine_plane(c0, c1, 2, ci))
    return planes


def mc_chroma_dense(refs_cb, refs_cr, mv, slot, pf, wts, ex, H, W,
                    bitdepth=8, bi=True, weighted=True):
    """Format-general chroma MC for the fused 4:2:2/4:4:4 path: per
    4x4-luma-block (ch,cw) chroma windows gathered straight from the
    chroma DPB stacks, epel taps with per-axis MV scaling
    (/root/reference/libde265/motion.cc:174-278). Correctness-first —
    the window gather is XLA-serialized (no tile table for these
    formats yet); rext content runs at small scales.
    Returns (Cb, Cr) int32 planes, clipped [0, maxv]."""
    R, Hc, Wc = refs_cb.shape
    subw, subh = W // Wc, H // Hc
    cw, ch = 4 // subw, 4 // subh
    n_by, n_bx = H // 4, W // 4
    N = n_by * n_bx
    bx = (jnp.arange(N, dtype=jnp.int32) % n_bx) * 4
    by = (jnp.arange(N, dtype=jnp.int32) // n_bx) * 4
    shift1 = min(4, bitdepth - 8)
    maxv = (1 << bitdepth) - 1
    shift = 14 - bitdepth
    etaps = jnp.asarray(EPEL_TAPS)

    def pred(refs_c, l):
        mvx = mv[:, l, 0] * (2 // subw)
        mvy = mv[:, l, 1] * (2 // subh)
        x0 = (bx // subw) + (mvx >> 3) - 1
        y0 = (by // subh) + (mvy >> 3) - 1
        rows = jnp.clip(y0[:, None] + jnp.arange(ch + 3)[None, :],
                        0, Hc - 1)
        cols = jnp.clip(x0[:, None] + jnp.arange(cw + 3)[None, :],
                        0, Wc - 1)
        win = refs_c[slot[:, l, None, None], rows[:, :, None],
                     cols[:, None, :]].astype(jnp.int32)
        th = etaps[mvx & 7]
        tv = etaps[mvy & 7]
        tmp = sum(th[:, k, None, None] * win[:, :, k:k + cw]
                  for k in range(4))
        tmp = tmp >> shift1
        out = sum(tv[:, k, None, None] * tmp[:, k:k + ch, :]
                  for k in range(4))
        return out >> 6                       # (N, ch, cw) 14-bit

    def to_plane(p):
        return p.reshape(n_by, n_bx, ch, cw).transpose(0, 2, 1, 3) \
                .reshape(Hc, Wc)

    def expand(a):
        g = a.reshape(n_by, n_bx)
        return jnp.broadcast_to(g[:, None, :, None],
                                (n_by, ch, n_bx, cw)).reshape(Hc, Wc)

    def combine(p0, p1, ci):
        P0 = to_plane(p0)
        P1 = to_plane(p1) if p1 is not None else None
        uni = jnp.clip((P0 + (1 << (shift - 1))) >> shift, 0, maxv)
        if P1 is None:
            dflt = uni
        else:
            has1 = expand(pf[:, 0] * pf[:, 1]) != 0
            bi_ = jnp.clip((P0 + P1 + (1 << shift)) >> (shift + 1),
                           0, maxv)
            dflt = jnp.where(has1, bi_, uni)
        if not weighted:
            return dflt
        w0 = expand(wts[:, ci, 0])
        o0 = expand(wts[:, ci, 1])
        l2 = expand(wts[:, ci, 4])
        euni = jnp.clip(((P0 * w0 + (1 << jnp.maximum(l2 - 1, 0)) *
                          (l2 >= 1)) >> l2) + o0, 0, maxv)
        exm = expand(ex.astype(jnp.int32)) != 0
        if P1 is None:
            return jnp.where(exm, euni, uni)
        w1 = expand(wts[:, ci, 2])
        o1 = expand(wts[:, ci, 3])
        ebi = jnp.clip((P0 * w0 + P1 * w1 + ((o0 + o1 + 1) << l2))
                       >> (l2 + 1), 0, maxv)
        return jnp.where(exm, jnp.where(has1, ebi, euni), dflt)

    out = []
    for ci, refs_c in ((1, refs_cb), (2, refs_cr)):
        p0 = pred(refs_c, 0)
        p1 = pred(refs_c, 1) if bi else None
        out.append(combine(p0, p1, ci))
    return out[0], out[1]


@partial(jax.jit, static_argnames=("dims", "bitdepth", "mc_caps",
                                   "mc_caps_c"))
def _mc_standalone(refs_y, refs_cb, refs_cr, mv, slot, pf, wts, ex,
                   dims, bitdepth, mc_caps=None, mc_caps_c=None):
    tables = build_tables(refs_y, refs_cb, refs_cr, bitdepth=bitdepth)
    return mc_frame_tile(tables, dims, mv, slot, pf, wts, ex, bitdepth,
                         mc_caps=mc_caps, mc_caps_c=mc_caps_c)


def motion_compensate_frame_tile(plan, planes, dpb, bitdepth=8,
                                 mc_caps=None, mc_caps_c=None):
    """Drop-in replacement for inter_dense_jax.motion_compensate_frame_dense
    using the tile-table path (4:2:0); mc_caps / mc_caps_c select the
    class-masked matmul MC (ProgramCfg's capacities). planes modified in
    place."""
    from .inter_dense_jax import build_block_arrays, REF_STACK
    if not plan.pus:
        return
    fids = sorted({pu.ref_dpb[l] for pu in plan.pus for l in range(2)
                   if pu.pred_flag[l]})
    if not fids:
        return
    slot_of = {fid: i for i, fid in enumerate(fids)}
    stacks = []
    for ci in range(3):
        arrs = [np.asarray(dpb.pics[f].planes[ci], np.int32) for f in fids]
        while len(arrs) < REF_STACK:
            arrs.append(np.zeros_like(arrs[0]))
        stacks.append(jnp.asarray(np.stack(arrs[:REF_STACK])))
    mv, slot, pf, wts, ex, inter = build_block_arrays(plan, slot_of, bitdepth)
    outs = _mc_standalone(stacks[0], stacks[1], stacks[2],
                          jnp.asarray(mv), jnp.asarray(slot), jnp.asarray(pf),
                          jnp.asarray(wts), jnp.asarray(ex),
                          (plan.H, plan.W), bitdepth, mc_caps or None,
                          mc_caps_c or None)
    n_by, n_bx = plan.H // 4, plan.W // 4
    m_y = np.kron(inter.reshape(n_by, n_bx), np.ones((4, 4), bool))
    m_c = np.kron(inter.reshape(n_by, n_bx), np.ones((2, 2), bool))
    dt = planes[0].dtype
    for ci in range(3):
        m = m_y if ci == 0 else m_c
        out = np.asarray(outs[ci]).astype(dt)
        planes[ci][m] = out[m]
