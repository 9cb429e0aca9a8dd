"""Whole-frame vectorized deblocking on the device (JAX/XLA), bit-exact.

Split: the *host* derives per-edge-segment metadata (boundary
strength, per-side QP, filter-off masks) as dense tensors from the FramePlan
grids — cheap numpy work that mirrors derive_edgeFlags/derive_boundaryStrength
(/root/reference/libde265/deblock.cc:130-377). The *device* then runs the
purely data-parallel filter math (8.7.2.5) over all segments at once:
V pass on the whole frame, then H pass. No per-CTB locks — XLA dataflow
replaces the reference's progress-lock pipeline (deblock.cc:914-989).
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .deblock_ref import BETA_TABLE, TC_TABLE, derive_bs, _filters_off, _edge_enabled
from .deblock_ref import CHROMA_QP_TABLE
from .lut import take_small

BETA_ARR = np.asarray(BETA_TABLE, np.int32)
TC_ARR = np.asarray(TC_TABLE, np.int32)


def plan_luma_metadata(plan, vertical):
    """Host-side: per 4-sample segment on the 8x8 edge grid, produce
    (bs, qp_avg, beta_off, tc_off, p_off, q_off) dense arrays.
    Shape: vertical: (H/4, W/8 - ...) segments at x=8,16,..; horizontal
    transposed equivalently."""
    W, H = plan.W, plan.H
    sh_map = {int(s.slice_segment_address): s for s in plan.slice_headers}
    sps = plan.sps

    if vertical:
        xs = list(range(8, W, 8))
        ys = list(range(0, H, 4))
    else:
        xs = list(range(0, W, 4))
        ys = list(range(8, H, 8))
    n_e = len(xs) if vertical else len(ys)
    n_s = len(ys) if vertical else len(xs)
    bs = np.zeros((n_s, n_e), np.int32)
    qp = np.zeros((n_s, n_e), np.int32)
    beta_off = np.zeros((n_s, n_e), np.int32)
    tc_off = np.zeros((n_s, n_e), np.int32)
    p_off = np.zeros((n_s, n_e), bool)
    q_off = np.zeros((n_s, n_e), bool)
    log2ctb = sps.Log2CtbSizeY

    for ei, e in enumerate(xs if vertical else ys):
        for si, s in enumerate(ys if vertical else xs):
            x, y = (e, s) if vertical else (s, e)
            edge = plan.tu_boundary[y >> 2, x >> 2] | \
                plan.cb_boundary[y >> 2, x >> 2] | plan.pb_boundary[y >> 2, x >> 2]
            if not (edge & (1 if vertical else 2)):
                continue
            if not _edge_enabled(plan, x, y, vertical, sh_map):
                continue
            sh = sh_map.get(int(plan.ctb_slice_seg[y >> log2ctb, x >> log2ctb]))
            if sh is None or sh.slice_deblocking_filter_disabled_flag:
                continue
            b = derive_bs(plan, x, y, vertical)
            if b == 0:
                continue
            bs[si, ei] = b
            if vertical:
                qp_p = int(plan.qp_y[y >> 2, (x - 1) >> 2])
                po = _filters_off(plan, (x - 1) >> 2, y >> 2)
                qo = _filters_off(plan, x >> 2, y >> 2)
            else:
                qp_p = int(plan.qp_y[(y - 1) >> 2, x >> 2])
                po = _filters_off(plan, x >> 2, (y - 1) >> 2)
                qo = _filters_off(plan, x >> 2, y >> 2)
            qp_q = int(plan.qp_y[y >> 2, x >> 2])
            qp[si, ei] = (qp_p + qp_q + 1) >> 1
            beta_off[si, ei] = sh.slice_beta_offset
            tc_off[si, ei] = sh.slice_tc_offset
            p_off[si, ei] = po
            q_off[si, ei] = qo
    return bs, qp, beta_off, tc_off, p_off, q_off


@partial(jax.jit, static_argnames=("vertical", "bitdepth"))
def deblock_luma_pass(Y, bs, qp, beta_off, tc_off, p_off, q_off,
                      vertical, bitdepth=8):
    """Y: (H,W) int32 plane. Segment metadata from plan_luma_metadata
    ((n_s, n_e): 4-sample segments x edges, the planner's orientation for
    this direction). Returns filtered plane (spec 8.7.2.5.3/4/7).

    Frame-layout formulation: the plane is sliced into 8 phase arrays
    Cj = samples at distance j from their window start (stride-8 static
    slices), all filter math runs elementwise on those, and the result
    interleaves back — no (n_s, 4, n_e, 8) segment shuffle and no full
    4K transpose for the horizontal pass."""
    H, W = Y.shape
    n_s, n_e = bs.shape
    ax = 1 if vertical else 0          # axis the edge windows stride along
    la = 0 if vertical else 1          # axis running along the edge (lines)
    span = 8 * n_e

    def phase(j):
        """(H, n_e)/(n_e, W) slice of window position j (p3..q3 = 0..7)."""
        if vertical:
            return Y[:, 4 + j:4 + j + span:8]
        return Y[4 + j:4 + j + span:8, :]

    C = [phase(j) for j in range(8)]
    p3, p2, p1, p0, q0, q1, q2, q3 = C

    # --- per-segment metadata -> per-line orientation
    # planner emits (segments, edges); for the horizontal pass the phase
    # arrays are (edges, lines*4), so metadata transposes (tiny arrays).
    def orient(m):
        return m if vertical else m.T

    bs_o = orient(bs)
    beta = take_small(BETA_ARR, jnp.clip(orient(qp) + orient(beta_off),
                                         0, 51)) << (bitdepth - 8)
    tc = take_small(TC_ARR, jnp.clip(orient(qp) + 2 * (bs_o - 1) +
                                     orient(tc_off), 0, 53)) << (bitdepth - 8)
    po_s = orient(p_off)
    qo_s = orient(q_off)

    def line(a, i):
        """Line i (0..3) of every segment: stride-4 slice on the line axis."""
        return a[i::4] if vertical else a[:, i::4]

    def rep4(m):
        """Per-segment -> per-line: 4x repeat along the line axis."""
        return jnp.repeat(m, 4, axis=la)

    # --- decisions (per segment, from lines 0 and 3)
    dp_l = jnp.abs(p2 - 2 * p1 + p0)          # per line
    dq_l = jnp.abs(q2 - 2 * q1 + q0)
    dp0, dp3 = line(dp_l, 0), line(dp_l, 3)
    dq0, dq3 = line(dq_l, 0), line(dq_l, 3)
    d = dp0 + dp3 + dq0 + dq3
    active = (bs_o > 0) & (d < beta) & (tc > 0)

    sd_l = jnp.abs(p3 - p0) + jnp.abs(q0 - q3)
    pq_l = jnp.abs(p0 - q0)

    def strong_line(i):
        dpi = dp0 if i == 0 else dp3
        dqi = dq0 if i == 0 else dq3
        return (2 * (dpi + dqi) < (beta >> 2)) & \
            (line(sd_l, i) < (beta >> 3)) & \
            (line(pq_l, i) < ((5 * tc + 1) >> 1))
    strong = strong_line(0) & strong_line(3)               # per segment

    maxv = (1 << bitdepth) - 1
    tc_ = rep4(tc)
    # strong filter (per line)
    sp0 = jnp.clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                   p0 - 2 * tc_, p0 + 2 * tc_)
    sp1 = jnp.clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - 2 * tc_, p1 + 2 * tc_)
    sp2 = jnp.clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                   p2 - 2 * tc_, p2 + 2 * tc_)
    sq0 = jnp.clip((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                   q0 - 2 * tc_, q0 + 2 * tc_)
    sq1 = jnp.clip((p0 + q0 + q1 + q2 + 2) >> 2, q1 - 2 * tc_, q1 + 2 * tc_)
    sq2 = jnp.clip((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3,
                   q2 - 2 * tc_, q2 + 2 * tc_)
    # weak filter (per line)
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    weak_line = jnp.abs(delta) < 10 * tc_
    dlt = jnp.clip(delta, -tc_, tc_)
    wp0 = jnp.clip(p0 + dlt, 0, maxv)
    wq0 = jnp.clip(q0 - dlt, 0, maxv)
    dEp = rep4((dp0 + dp3) < ((beta + (beta >> 1)) >> 3))
    dEq = rep4((dq0 + dq3) < ((beta + (beta >> 1)) >> 3))
    dp_ = jnp.clip((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1,
                   -(tc_ >> 1), tc_ >> 1)
    dq_ = jnp.clip((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1,
                   -(tc_ >> 1), tc_ >> 1)
    wp1 = jnp.clip(p1 + dp_, 0, maxv)
    wq1 = jnp.clip(q1 + dq_, 0, maxv)

    st = rep4(strong)
    act = rep4(active)
    po = rep4(po_s)
    qo = rep4(qo_s)
    np0 = jnp.where(st, sp0, jnp.where(weak_line, wp0, p0))
    np1 = jnp.where(st, sp1, jnp.where(weak_line & dEp, wp1, p1))
    np2 = jnp.where(st, sp2, p2)
    nq0 = jnp.where(st, sq0, jnp.where(weak_line, wq0, q0))
    nq1 = jnp.where(st, sq1, jnp.where(weak_line & dEq, wq1, q1))
    nq2 = jnp.where(st, sq2, q2)
    np0 = jnp.where(act & ~po, jnp.clip(np0, 0, maxv), p0)
    np1 = jnp.where(act & ~po, jnp.clip(np1, 0, maxv), p1)
    np2 = jnp.where(act & ~po, jnp.clip(np2, 0, maxv), p2)
    nq0 = jnp.where(act & ~qo, jnp.clip(nq0, 0, maxv), q0)
    nq1 = jnp.where(act & ~qo, jnp.clip(nq1, 0, maxv), q1)
    nq2 = jnp.where(act & ~qo, jnp.clip(nq2, 0, maxv), q2)

    newC = [p3, np2, np1, np0, nq0, nq1, nq2, q3]
    strip = jnp.stack(newC, axis=ax + 1)
    if vertical:
        strip = strip.reshape(H, span)
        return jnp.concatenate([Y[:, :4], strip, Y[:, 4 + span:]], axis=1)
    strip = strip.reshape(span, W)
    return jnp.concatenate([Y[:4], strip, Y[4 + span:]], axis=0)


def plan_chroma_metadata(plan, vertical):
    """Host-side chroma metadata: segments of 2 chroma lines, edges every
    8 CHROMA samples (8.7.2 filters chroma where xC/yC is an 8-multiple —
    luma 16-grid for 4:2:0, but e.g. every 8 luma rows for 4:2:2
    horizontal edges); bS==2 only. Edge/bS/QP lookups map back to luma
    coordinates via SubWidthC/SubHeightC."""
    W, H = plan.W, plan.H
    sps, pps = plan.sps, plan.pps
    subw, subh = sps.SubWidthC, sps.SubHeightC
    Wc, Hc = W // subw, H // subh
    sh_map = {int(s.slice_segment_address): s for s in plan.slice_headers}
    log2ctb = sps.Log2CtbSizeY
    if vertical:
        xs = list(range(8, Wc, 8))        # chroma cols
        ys = list(range(0, Hc, 2))        # 2-chroma-row segments
    else:
        xs = list(range(0, Wc, 2))
        ys = list(range(8, Hc, 8))
    n_e = len(xs) if vertical else len(ys)
    n_s = len(ys) if vertical else len(xs)
    act = np.zeros((2, n_s, n_e), bool)   # per chroma component
    tc = np.zeros((2, n_s, n_e), np.int32)
    p_off = np.zeros((n_s, n_e), bool)
    q_off = np.zeros((n_s, n_e), bool)
    for ei, e in enumerate(xs if vertical else ys):
        for si, s in enumerate(ys if vertical else xs):
            xc, yc = (e, s) if vertical else (s, e)
            x, y = xc * subw, yc * subh
            edge = plan.tu_boundary[y >> 2, x >> 2] | plan.cb_boundary[y >> 2, x >> 2]
            if not (edge & (1 if vertical else 2)):
                continue
            if not _edge_enabled(plan, x, y, vertical, sh_map):
                continue
            sh = sh_map.get(int(plan.ctb_slice_seg[y >> log2ctb, x >> log2ctb]))
            if sh is None or sh.slice_deblocking_filter_disabled_flag:
                continue
            if derive_bs(plan, x, y, vertical) != 2:
                continue
            if vertical:
                qp_p = int(plan.qp_y[y >> 2, (x - 1) >> 2])
                po = _filters_off(plan, (x - 1) >> 2, y >> 2)
                qo = _filters_off(plan, x >> 2, y >> 2)
            else:
                qp_p = int(plan.qp_y[(y - 1) >> 2, x >> 2])
                po = _filters_off(plan, x >> 2, (y - 1) >> 2)
                qo = _filters_off(plan, x >> 2, y >> 2)
            qp_q = int(plan.qp_y[y >> 2, x >> 2])
            for c in range(2):
                qoff = pps.pic_cb_qp_offset if c == 0 else pps.pic_cr_qp_offset
                qpi = min(57, max(0, ((qp_p + qp_q + 1) >> 1) + qoff))
                if sps.ChromaArrayType == 1:
                    qpc = qpi if qpi < 30 else (
                        qpi - 6 if qpi > 43 else CHROMA_QP_TABLE[qpi - 30])
                else:
                    qpc = min(qpi, 51)
                Qt = min(53, max(0, qpc + 2 + sh.slice_tc_offset))
                tcv = TC_TABLE[Qt] << (sps.BitDepthC - 8)
                if tcv > 0:
                    act[c, si, ei] = True
                    tc[c, si, ei] = tcv
            p_off[si, ei] = po
            q_off[si, ei] = qo
    return act, tc, p_off, q_off


@partial(jax.jit, static_argnames=("vertical", "bitdepth", "rep"))
def deblock_chroma_pass(C, act, tc, p_off, q_off, vertical, bitdepth=8,
                        rep=2):
    """C: chroma plane (int32); metadata for this component.
    Frame-layout phase slices (see deblock_luma_pass); edges at chroma
    x/y = 8*(ei+1), p1..q1 window at offsets 6..9. The maps are in
    4x4-LUMA-row granularity along the edge; `rep` expands each map row
    onto its chroma lines (2 for a halved axis, 4 for a full-res axis —
    4:2:2 vertical / 4:4:4; deblock.cc:738-757)."""
    n_s, n_e = act.shape
    ax = 1 if vertical else 0
    la = 0 if vertical else 1
    span = 8 * n_e
    # the strided phase windows read up to index span+5 along the
    # filtered axis; chroma dims that aren't 8-multiples (e.g. 540 for
    # 1080p) need a pad (real edges never touch the pad — the planner
    # only emits edges whose 4 filtered lines are inside the picture)
    Hc0, Wc0 = C.shape
    need = span + 6
    if vertical and Wc0 < need:
        C = jnp.pad(C, ((0, 0), (0, need - Wc0)))
    elif not vertical and Hc0 < need:
        C = jnp.pad(C, ((0, need - Hc0), (0, 0)))

    def phase(j):
        if vertical:
            return C[:, 6 + j:6 + j + span:8]
        return C[6 + j:6 + j + span:8, :]

    Cs = [phase(j) for j in range(8)]
    p1, p0, q0, q1 = Cs[0], Cs[1], Cs[2], Cs[3]

    def orient(m):
        return m if vertical else m.T

    def rep2(m):
        return jnp.repeat(m, rep, axis=la)

    maxv = (1 << bitdepth) - 1
    tc_ = rep2(orient(tc))
    act_ = rep2(orient(act))
    po = rep2(orient(p_off))
    qo = rep2(orient(q_off))
    delta = jnp.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc_, tc_)
    np0 = jnp.where(act_ & ~po, jnp.clip(p0 + delta, 0, maxv), p0)
    nq0 = jnp.where(act_ & ~qo, jnp.clip(q0 - delta, 0, maxv), q0)
    newC = [p1, np0, nq0, q1] + Cs[4:]
    strip = jnp.stack(newC, axis=ax + 1)
    if vertical:
        strip = strip.reshape(C.shape[0], span)
        return jnp.concatenate([C[:, :6], strip, C[:, 6 + span:]],
                               axis=1)[:, :Wc0]
    strip = strip.reshape(span, C.shape[1])
    return jnp.concatenate([C[:6], strip, C[6 + span:]], axis=0)[:Hc0]


def deblock_frame_jax(plan, planes):
    """Drop-in replacement for deblock_ref.deblock_frame using the device."""
    Y = jnp.asarray(planes[0], jnp.int32)
    for vertical in (True, False):
        meta = plan_luma_metadata(plan, vertical)
        if meta[0].size:
            Y = deblock_luma_pass(Y, *[jnp.asarray(m) for m in meta],
                                  vertical=vertical, bitdepth=plan.sps.BitDepthY)
    planes[0][...] = np.asarray(Y).astype(planes[0].dtype)
    if plan.sps.ChromaArrayType == 0:
        return
    for vertical in (True, False):
        act, tc, p_off, q_off = plan_chroma_metadata(plan, vertical)
        if not act.size:
            continue
        for c in (0, 1):
            Cp = jnp.asarray(planes[c + 1], jnp.int32)
            Cp = deblock_chroma_pass(Cp, jnp.asarray(act[c]), jnp.asarray(tc[c]),
                                     jnp.asarray(p_off), jnp.asarray(q_off),
                                     vertical=vertical,
                                     bitdepth=plan.sps.BitDepthC)
            planes[c + 1][...] = np.asarray(Cp).astype(planes[c + 1].dtype)
