"""Dense per-4x4-block motion compensation — one static-shape program.

Dense redesign of the bucketed MC in inter_jax.py: instead of grouping
PUs by (w, h) (reference acceleration.h qpel[4][4] per-size kernels; each
new bucket is a fresh XLA program), every 4x4 luma block of the frame is
motion-compensated independently from the frame's 4x4 motion field
(spec 8.5.3.3 applies per-PU, but all blocks of a PU share its MV, so the
per-block result is identical). The program shape depends only on
(H, W, ref-stack depth), so one compilation serves every frame of a
stream — the key to dispatch-efficient end-to-end decode over a slow
host<->device link.

Chroma rides along at 2x2 blocks on the same N-block axis (4:2:0).
Weighted prediction (spec 8.5.3.3.4, explicit + default) is applied
per block with per-block weight arrays gathered on the host.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .inter_jax import QPEL_TAPS, EPEL_TAPS

REF_STACK = 8   # fixed DPB stack depth (pad) so the program shape is static


@partial(jax.jit, static_argnames=("bitdepth",))
def mc_dense(refs_y, refs_cb, refs_cr, mv, slot, pf,
             wts, ex, bitdepth=8):
    """All-blocks MC.

    refs_*  : (R, H, W) / (R, H/2, W/2) int32 reference stacks
    mv      : (N, 2, 2) int32 quarter-pel MVs per block per list
    slot    : (N, 2) int32 ref stack slot per list
    pf      : (N, 2) int32 pred flags
    wts     : (N, 3, 5) int32 per-plane (w0, o0, w1, o1, log2Wd)
    ex      : (N,) bool explicit-weighted flag
    Returns [Y, Cb, Cr] dense int32 planes (N laid out row-major in blocks).
    """
    R, H, W = refs_y.shape
    n_by, n_bx = H // 4, W // 4
    N = n_by * n_bx
    bx = (jnp.arange(N, dtype=jnp.int32) % n_bx) * 4
    by = (jnp.arange(N, dtype=jnp.int32) // n_bx) * 4
    shift1 = min(4, bitdepth - 8)
    maxv = (1 << bitdepth) - 1
    shift = 14 - bitdepth
    qtaps = jnp.asarray(QPEL_TAPS)
    etaps = jnp.asarray(EPEL_TAPS)

    def luma_pred(l):
        mvx, mvy = mv[:, l, 0], mv[:, l, 1]
        x0 = bx + (mvx >> 2) - 3
        y0 = by + (mvy >> 2) - 3
        rows = jnp.clip(y0[:, None] + jnp.arange(11)[None, :], 0, H - 1)
        cols = jnp.clip(x0[:, None] + jnp.arange(11)[None, :], 0, W - 1)
        win = refs_y[slot[:, l, None, None], rows[:, :, None], cols[:, None, :]]
        th = qtaps[mvx & 3]                     # (N, 8)
        tv = qtaps[mvy & 3]
        tmp = sum(th[:, k, None, None] * win[:, :, k:k + 4] for k in range(8))
        tmp = tmp >> shift1
        out = sum(tv[:, k, None, None] * tmp[:, k:k + 4, :] for k in range(8))
        return out >> 6                          # (N, 4, 4) 14-bit

    def chroma_pred(refs_c, l):
        # format-general per motion.cc:190-191: the luma quarter-pel MV
        # scales by 2/SubWidthC (resp. /SubHeightC) into chroma
        # eighth-pel units; subsampling factors come from the static
        # plane shapes, so 4:2:0 / 4:2:2 / 4:4:4 each trace their own
        # block geometry (2x2 / 2x4 / 4x4)
        Hc, Wc = refs_c.shape[1], refs_c.shape[2]
        subw, subh = W // Wc, H // Hc
        cw, ch = 4 // subw, 4 // subh
        mvx = mv[:, l, 0] * (2 // subw)
        mvy = mv[:, l, 1] * (2 // subh)
        x0 = (bx // subw) + (mvx >> 3) - 1
        y0 = (by // subh) + (mvy >> 3) - 1
        rows = jnp.clip(y0[:, None] + jnp.arange(ch + 3)[None, :], 0, Hc - 1)
        cols = jnp.clip(x0[:, None] + jnp.arange(cw + 3)[None, :], 0, Wc - 1)
        win = refs_c[slot[:, l, None, None], rows[:, :, None], cols[:, None, :]]
        th = etaps[mvx & 7]
        tv = etaps[mvy & 7]
        tmp = sum(th[:, k, None, None] * win[:, :, k:k + cw] for k in range(4))
        tmp = tmp >> shift1
        out = sum(tv[:, k, None, None] * tmp[:, k:k + ch, :] for k in range(4))
        return out >> 6                          # (N, ch, cw) 14-bit

    def combine(p0, p1, ci):
        has1 = (pf[:, 0] * pf[:, 1])[:, None, None] != 0
        w0 = wts[:, ci, 0][:, None, None]
        o0 = wts[:, ci, 1][:, None, None]
        w1 = wts[:, ci, 2][:, None, None]
        o1 = wts[:, ci, 3][:, None, None]
        l2 = wts[:, ci, 4][:, None, None]
        bi = jnp.clip((p0 + p1 + (1 << shift)) >> (shift + 1), 0, maxv)
        uni = jnp.clip((p0 + (1 << (shift - 1))) >> shift, 0, maxv)
        dflt = jnp.where(has1, bi, uni)
        ebi = jnp.clip((p0 * w0 + p1 * w1 + ((o0 + o1 + 1) << l2)) >> (l2 + 1),
                       0, maxv)
        euni = jnp.clip(((p0 * w0 + (1 << jnp.maximum(l2 - 1, 0)) *
                          (l2 >= 1)) >> l2) + o0, 0, maxv)
        expl = jnp.where(has1, ebi, euni)
        return jnp.where(ex[:, None, None], expl, dflt)

    # slot 0 of the two prediction "lanes" carries the single prediction of a
    # uni-pred block (host swaps L1-only blocks into lane 0)
    y0p = luma_pred(0)
    y1p = luma_pred(1)
    yv = combine(y0p, y1p, 0)
    yplane = yv.reshape(n_by, n_bx, 4, 4).transpose(0, 2, 1, 3).reshape(H, W)
    planes = [yplane]
    for ci, refs_c in ((1, refs_cb), (2, refs_cr)):
        if refs_c is None:               # monochrome
            continue
        Hc, Wc = refs_c.shape[1], refs_c.shape[2]
        cw, ch = (4 * Wc) // W, (4 * Hc) // H
        c0 = chroma_pred(refs_c, 0)
        c1 = chroma_pred(refs_c, 1)
        cv = combine(c0, c1, ci)
        planes.append(cv.reshape(n_by, n_bx, ch, cw)
                        .transpose(0, 2, 1, 3).reshape(Hc, Wc))
    return planes


def build_block_arrays(plan, slot_of, bitdepth=8):
    """Host-side: expand per-PU motion/weights into per-4x4-block arrays.
    Lane 0 always holds the (first) prediction; lane 1 only for bi-pred."""
    H, W = plan.H, plan.W
    n_by, n_bx = H // 4, W // 4
    N = n_by * n_bx
    mv = np.zeros((N, 2, 2), np.int32)
    slot = np.zeros((N, 2), np.int32)
    pf = np.zeros((N, 2), np.int32)
    wts = np.zeros((N, 3, 5), np.int32)
    ex = np.zeros(N, bool)
    inter = np.zeros(N, bool)

    def blk_slice(x, y, w, h):
        bys, bxs = y // 4, x // 4
        return (slice(bys, bys + h // 4), slice(bxs, bxs + w // 4))

    idx2d = np.arange(N).reshape(n_by, n_bx)
    for pu in plan.pus:
        sl = idx2d[blk_slice(pu.x, pu.y, pu.w, pu.h)].ravel()
        inter[sl] = True
        if pu.pred_flag[0] and pu.pred_flag[1]:
            lanes = [(0, 0), (1, 1)]
            pf[sl] = 1
        else:
            l = 0 if pu.pred_flag[0] else 1
            lanes = [(0, l)]
            pf[sl, 0] = 1
        sh = pu.slice_header
        pw = sh.pred_weight
        for lane, l in lanes:
            mv[sl, lane, 0] = pu.mv[l][0]
            mv[sl, lane, 1] = pu.mv[l][1]
            slot[sl, lane] = slot_of[pu.ref_dpb[l]]
            if pw is not None:
                r = pu.ref_idx[l]
                for ci in range(3):
                    if ci == 0:
                        denom = pw.luma_log2_weight_denom
                        wv, ov = pw.luma_weight[l][r], pw.luma_offset[l][r]
                    else:
                        denom = pw.chroma_log2_weight_denom
                        wv = pw.chroma_weight[l][r][ci - 1]
                        ov = pw.chroma_offset[l][r][ci - 1]
                    wts[sl, ci, 4] = denom + 14 - bitdepth
                    wts[sl, ci, 0 if lane == 0 else 2] = wv
                    wts[sl, ci, 1 if lane == 0 else 3] = ov
        if pw is not None:
            ex[sl] = True
    return mv, slot, pf, wts, ex, inter


def motion_compensate_frame_dense(plan, planes, dpb, bitdepth=8):
    """Drop-in replacement for inter_jax.motion_compensate_frame_device
    using the dense one-program path. planes modified in place."""
    if not plan.pus:
        return
    fids = sorted({pu.ref_dpb[l] for pu in plan.pus for l in range(2)
                   if pu.pred_flag[l]})
    if not fids:
        return
    slot_of = {fid: i for i, fid in enumerate(fids)}
    mono = planes[1].size == 0
    stacks = []
    for ci in range(1 if mono else 3):
        arrs = [np.asarray(dpb.pics[f].planes[ci], np.int32) for f in fids]
        while len(arrs) < REF_STACK:
            arrs.append(np.zeros_like(arrs[0]))
        stacks.append(jnp.asarray(np.stack(arrs[:REF_STACK])))
    if mono:
        stacks += [None, None]
    mv, slot, pf, wts, ex, inter = build_block_arrays(plan, slot_of, bitdepth)
    outs = mc_dense(stacks[0], stacks[1], stacks[2],
                    jnp.asarray(mv), jnp.asarray(slot), jnp.asarray(pf),
                    jnp.asarray(wts), jnp.asarray(ex), bitdepth)
    n_by, n_bx = plan.H // 4, plan.W // 4
    dt = planes[0].dtype
    for ci in range(1 if mono else 3):
        ch, cw = ((4, 4) if ci == 0 else
                  (planes[ci].shape[0] // n_by, planes[ci].shape[1] // n_bx))
        m = np.kron(inter.reshape(n_by, n_bx), np.ones((ch, cw), bool))
        out = np.asarray(outs[ci]).astype(dt)
        planes[ci][m] = out[m]
