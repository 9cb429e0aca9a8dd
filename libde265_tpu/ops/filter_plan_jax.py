"""On-device derivation of loop-filter metadata from decode-plan grids.

The round-1 planners (deblock_jax.plan_luma_metadata etc.) walk every edge
in Python — fine for CIF test vectors, hopeless at 4K (260k edges/frame).
This module derives the same dense metadata tensors *on device* from the
front-end's 4x4/CTB grids, so the whole filter chain (plan + deblock V/H +
SAO) lives inside the one compiled frame program.

Reference semantics: boundary strength /root/reference/libde265/deblock.cc:241-377,
edge flags deblock.cc:130-239, slice/tile gating deblock.cc:1020-1058 and
sao.cc:140-200. Bit-exactness is established differentially against the
host planners (tests/test_filter_plan.py) which are themselves golden-MD5
verified.

Host-side inputs prepared once per frame (all tiny or already needed by MC):
  grids4: pm, cbf, tucb, edgeall (tucb|pb), qp, off (tq/pcm), pf, mv, poc
  ctb:    sidx (CTB -> slice-table row), allow_v/allow_h (CTB-pair edge
          permission incl. tiles), per-slice param table
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .deblock_ref import BETA_TABLE, TC_TABLE, CHROMA_QP_TABLE
from .lut import take_small

TC_ARR = np.asarray(TC_TABLE, np.int32)
CHROMA_QP_ARR = np.asarray(CHROMA_QP_TABLE, np.int32)


def _far(mva, mvb):
    """|mv delta| >= 4 in either component. mva/mvb: (..., 2)."""
    return (jnp.abs(mva[..., 0] - mvb[..., 0]) >= 4) | \
           (jnp.abs(mva[..., 1] - mvb[..., 1]) >= 4)


def _bs_motion(pf_p, mv_p, poc_p, pf_q, mv_q, poc_q):
    """Vectorized spec 8.7.2.4 motion-difference test -> bs (0 or 1).
    pf_*: (..., 2) int; mv_*: (..., 2, 2); poc_*: (..., 2)."""
    np_ = pf_p[..., 0] + pf_p[..., 1]
    nq_ = pf_q[..., 0] + pf_q[..., 1]

    # --- single prediction each side: compare the one active lane
    # (2-entry lane select, NOT take_along_axis — no gather)
    p_has0 = pf_p[..., 0] > 0
    q_has0 = pf_q[..., 0] > 0
    pocp1 = jnp.where(p_has0, poc_p[..., 0], poc_p[..., 1])
    pocq1 = jnp.where(q_has0, poc_q[..., 0], poc_q[..., 1])
    mvp1 = jnp.where(p_has0[..., None], mv_p[..., 0, :], mv_p[..., 1, :])
    mvq1 = jnp.where(q_has0[..., None], mv_q[..., 0, :], mv_q[..., 1, :])
    single = (pocp1 != pocq1) | _far(mvp1, mvq1)

    # --- two predictions each side
    pp0, pp1 = poc_p[..., 0], poc_p[..., 1]
    qq0, qq1 = poc_q[..., 0], poc_q[..., 1]
    set_neq = (jnp.minimum(pp0, pp1) != jnp.minimum(qq0, qq1)) | \
              (jnp.maximum(pp0, pp1) != jnp.maximum(qq0, qq1))
    p0, p1 = mv_p[..., 0, :], mv_p[..., 1, :]
    q0, q1 = mv_q[..., 0, :], mv_q[..., 1, :]
    same_ref = pp0 == pp1
    both_same = (_far(p0, q0) | _far(p1, q1)) & (_far(p0, q1) | _far(p1, q0))
    # distinct pictures: align q to p by POC
    swap = pp0 != qq0
    q0a = jnp.where(swap[..., None], q1, q0)
    q1a = jnp.where(swap[..., None], q0, q1)
    aligned = _far(p0, q0a) | _far(p1, q1a)
    double = set_neq | jnp.where(same_ref, both_same, aligned)

    return jnp.where(np_ != nq_, 1,
                     jnp.where(np_ == 1, single.astype(jnp.int32),
                               jnp.where(np_ == 2,
                                         double.astype(jnp.int32), 0)))


def _expand_edge_ctb(arr_ctb, si_luma_y, e_luma_x, log2ctb):
    """Gather a CTB-grid array to the (n_s, n_e) edge grid. Coordinates
    are GLOBAL luma positions, clipped into the picture (halo positions
    of a sharded strip read their nearest in-picture CTB; their results
    are cropped away by the caller)."""
    nctby, nctbx = arr_ctb.shape
    cy = jnp.clip(si_luma_y >> log2ctb, 0, nctby - 1)        # (n_s,)
    cx = jnp.clip(e_luma_x >> log2ctb, 0, nctbx - 1)         # (n_e,)
    return arr_ctb[cy][:, cx]


def _expand_edge_ctb_fast(arr_ctb, n_s, n_e, log2ctb, edge_px):
    """xoff==0 fast path of _expand_edge_ctb: the edge/sample coordinates
    are uniform strides, so the CTB lookup is a broadcast-repeat + crop
    (no gather). Row r covers luma
    y=4r; edge e covers luma x=edge_px*(e+1)."""
    ry = (1 << log2ctb) // 4
    rx = (1 << log2ctb) // edge_px
    rows = jnp.repeat(arr_ctb, ry, axis=0)[:n_s]
    return jnp.repeat(rows, rx, axis=1)[:, 1:1 + n_e]


@partial(jax.jit, static_argnames=("cfg",))
def plan_deblock_device(grids, cfg, xoff=0):
    """grids: dict of device arrays (see module docstring).
    cfg: hashable static config tuple
         (log2ctb, pcm_lf_disable, chroma_fmt, bd_y, bd_c, cb_qpoff,
          cr_qpoff, H, W).
    Returns (lm, cm): luma (v, h) tuples matching deblock_jax
    plan_luma_metadata order (bs, qp, beta_off, tc_off, p_off, q_off) and
    chroma (act, tc, p_off, q_off)."""
    (log2ctb, pcm_lfd, chroma_fmt, bd_y, bd_c, cb_qpoff, cr_qpoff,
     H, W) = cfg

    pm = grids["pm"].astype(jnp.int32)
    cbf = grids["cbf"].astype(jnp.int32)
    tucb = grids["tucb"].astype(jnp.int32)
    edgeall = grids["edgeall"].astype(jnp.int32)
    qp = grids["qp"].astype(jnp.int32)
    off = grids["off"].astype(jnp.int32)
    pf = grids["pf"].astype(jnp.int32)
    mv = grids["mv"].astype(jnp.int32)
    poc = grids["poc"].astype(jnp.int32)
    sidx = grids["sidx"].astype(jnp.int32)
    allow_v = grids["allow_v"].astype(jnp.int32)
    allow_h = grids["allow_h"].astype(jnp.int32)
    dis_tab = grids["sh_disable"].astype(jnp.int32)
    beta_tab = grids["sh_beta"].astype(jnp.int32)
    tc_tab = grids["sh_tc"].astype(jnp.int32)

    def luma_dir(vertical):
        if vertical:
            (pm_, cbf_, tucb_, edge_, qp_, off_, pf_, mv_, poc_) = (
                pm, cbf, tucb, edgeall, qp, off, pf, mv, poc)
            allow, sidx_, bit = allow_v, sidx, 1
        else:
            tr = lambda a: jnp.swapaxes(a, 0, 1)
            (pm_, cbf_, tucb_, edge_, qp_, off_, pf_, mv_, poc_) = (
                tr(pm), tr(cbf), tr(tucb), tr(edgeall), tr(qp), tr(off),
                tr(pf), tr(mv), tr(poc))
            allow, sidx_, bit = (jnp.swapaxes(allow_h, 0, 1),
                                 jnp.swapaxes(sidx, 0, 1), 2)
        # extents from the (possibly strip-local) grid itself
        We = pm_.shape[1] * 4
        n_e = We // 8 - 1
        n_s = pm_.shape[0]
        fast = isinstance(xoff, int) and xoff == 0
        # q/p-side columns are uniform stride-2 4x4-grid slices: use
        # strided slicing, not integer-array indexing (gather)
        def atq(a):
            return a[:, 2:2 + 2 * n_e:2]

        def atp(a):
            return a[:, 1:1 + 2 * n_e:2]
        if fast:
            allow_e = _expand_edge_ctb_fast(allow, n_s, n_e, log2ctb, 8) != 0
            se = _expand_edge_ctb_fast(sidx_, n_s, n_e, log2ctb, 8)
            is_ctb = ((jnp.arange(n_e) + 1) * 8
                      & ((1 << log2ctb) - 1)) == 0
        else:
            gq = 2 * (jnp.arange(n_e, dtype=jnp.int32) + 1)  # q-block col
            si = jnp.arange(n_s, dtype=jnp.int32)
            # global coordinates for CTB-level lookups (xoff: strip origin)
            e_x = gq * 4 + (xoff if vertical else 0)
            s_y = si * 4 + (0 if vertical else xoff)
            is_ctb = (e_x & ((1 << log2ctb) - 1)) == 0
            allow_e = _expand_edge_ctb(allow, s_y, e_x, log2ctb) != 0
            se = _expand_edge_ctb(sidx_, s_y, e_x, log2ctb)
        # CTB-boundary permission (tiles/slices); interior edges always ok
        allowed = jnp.where(is_ctb[None, :], allow_e, True)
        # q-side slice header params (select chains, not gathers)
        disabled = take_small(dis_tab, se) != 0
        beta_off = take_small(beta_tab, se)
        tc_off = take_small(tc_tab, se)

        edge_exists = (atq(edge_) & bit) != 0
        pm_q, pm_p = atq(pm_), atp(pm_)
        intra2 = (pm_q == 1) | (pm_p == 1)
        tu_edge = (atq(tucb_) & bit) != 0
        b1 = tu_edge & ((atq(cbf_) > 0) | (atp(cbf_) > 0))
        mvbs = _bs_motion(atp(pf_), atp(mv_), atp(poc_),
                          atq(pf_), atq(mv_), atq(poc_))
        bs = jnp.where(intra2, 2, jnp.where(b1, 1, mvbs))
        valid = edge_exists & allowed & ~disabled
        bs = jnp.where(valid, bs, 0)
        qp_avg = (atp(qp_) + atq(qp_) + 1) >> 1
        p_off = atp(off_) != 0
        q_off = atq(off_) != 0
        return (bs, qp_avg, beta_off, tc_off, p_off, q_off)

    lm = (luma_dir(True), luma_dir(False))

    if not chroma_fmt:
        return lm, None

    def chroma_dir(vertical):
        # per-format geometry (deblock.cc:738-757): chroma edges sit at
        # chroma x/y = 8*(ei+1) — luma spacing 8*sub along the
        # perpendicular axis (16 for 4:2:0's halved axes, 8 for 4:2:2's
        # vertical / 4:4:4's both)
        subw = 2 if chroma_fmt in (1, 2) else 1
        subh = 2 if chroma_fmt == 1 else 1
        if vertical:
            pm_, qp_, tucb_, off_ = pm, qp, tucb, off
            allow, sidx_, bit = allow_v, sidx, 1
            sp = 8 * subw                    # luma px between edges
        else:
            tr = lambda a: jnp.swapaxes(a, 0, 1)
            pm_, qp_, tucb_, off_ = tr(pm), tr(qp), tr(tucb), tr(off)
            allow, sidx_, bit = (jnp.swapaxes(allow_h, 0, 1),
                                 jnp.swapaxes(sidx, 0, 1), 2)
            sp = 8 * subh
        st = sp // 4                         # edge stride in 4x4 blocks
        We = pm_.shape[1] * 4
        n_e = We // sp - (1 if We % sp == 0 else 0)
        n_s = pm_.shape[0]
        fast = isinstance(xoff, int) and xoff == 0

        def atq(a):
            return a[:, st:st + st * n_e:st]

        def atp(a):
            return a[:, st - 1:st - 1 + st * n_e:st]
        if fast:
            allow_e = _expand_edge_ctb_fast(allow, n_s, n_e, log2ctb,
                                            sp) != 0
            se = _expand_edge_ctb_fast(sidx_, n_s, n_e, log2ctb, sp)
            is_ctb = ((jnp.arange(n_e) + 1) * sp
                      & ((1 << log2ctb) - 1)) == 0
        else:
            gq = st * (jnp.arange(n_e, dtype=jnp.int32) + 1)
            si = jnp.arange(n_s, dtype=jnp.int32)
            e_x = gq * 4 + (xoff if vertical else 0)
            s_y = si * 4 + (0 if vertical else xoff)
            is_ctb = (e_x & ((1 << log2ctb) - 1)) == 0
            allow_e = _expand_edge_ctb(allow, s_y, e_x, log2ctb) != 0
            se = _expand_edge_ctb(sidx_, s_y, e_x, log2ctb)
        edge_exists = (atq(tucb_) & bit) != 0
        allowed = jnp.where(is_ctb[None, :], allow_e, True)
        disabled = take_small(dis_tab, se) != 0
        tc_off = take_small(tc_tab, se)
        intra2 = (atq(pm_) == 1) | (atp(pm_) == 1)
        valid = edge_exists & allowed & ~disabled & intra2
        qp_avg = (atp(qp_) + atq(qp_) + 1) >> 1
        acts, tcs = [], []
        for qoff in (cb_qpoff, cr_qpoff):
            qpi = jnp.clip(qp_avg + qoff, 0, 57)
            if chroma_fmt == 1:
                qpc = jnp.where(
                    qpi < 30, qpi,
                    jnp.where(qpi > 43, qpi - 6,
                              take_small(CHROMA_QP_ARR,
                                         jnp.clip(qpi - 30, 0, 13))))
            else:
                qpc = jnp.minimum(qpi, 51)
            Qt = jnp.clip(qpc + 2 + tc_off, 0, 53)
            tcv = take_small(TC_ARR, Qt) << (bd_c - 8)
            acts.append(valid & (tcv > 0))
            tcs.append(jnp.where(valid, tcv, 0))
        p_off = atp(off_) != 0
        q_off = atq(off_) != 0
        return (jnp.stack(acts), jnp.stack(tcs), p_off, q_off)

    cm = (chroma_dir(True), chroma_dir(False))
    return lm, cm


@partial(jax.jit, static_argnames=("cfg", "cidx"))
def plan_sao_device(grids, cfg, cidx, xoff=0):
    """Expand per-CTB SAO params to per-sample maps on device.
    grids: sao_type/eo/band (nctby,nctbx,3), sao_off (nctby,nctbx,3,4),
    sidx, sh_sao_luma/chroma (S,), off (4x4 tq/pcm grid, possibly a
    halo-extended strip), pair_ok (4,nctby,nctbx). cfg: (log2ctb,
    chroma_fmt, H, W, subw, subh). xoff: global luma x of the off-grid's
    first column (sharded strips). CTB-level arrays are always global;
    the plane width follows the off grid. Returns tuple for sao_apply."""
    log2ctb, chroma_fmt, H, W, subw, subh = cfg
    sub = 1 if cidx == 0 else subw
    subv = 1 if cidx == 0 else subh
    Hs = H // subv
    Ws = (grids["off"].shape[1] * 4) // sub     # strip/frame plane width
    ctb = (1 << log2ctb) // sub
    ctbv = (1 << log2ctb) // subv

    # int8 per-CTB params: the expanded per-sample maps are the largest
    # tensors this planner materializes (11 full planes at 4K) — 4x less
    # HBM traffic than int32, and every consumer is a compare/select
    # (type<=2, eo<=3, band<=31, |offset|<=31 all fit)
    t = grids["sao_type"][:, :, cidx].astype(jnp.int8)
    eo = grids["sao_eo"][:, :, cidx].astype(jnp.int8)
    band = grids["sao_band"][:, :, cidx].astype(jnp.int8)
    offs = grids["sao_off"][:, :, cidx, :].astype(jnp.int8)
    sidx = grids["sidx"].astype(jnp.int32)
    en_tab = (grids["sh_sao_luma"] if cidx == 0 else
              grids["sh_sao_chroma"]).astype(jnp.int32)
    enable = take_small(en_tab, sidx) != 0
    t = jnp.where(enable, t, 0)

    nctby, nctbx = t.shape
    # global plane-unit coordinates of each strip sample
    gx_plane = jnp.arange(Ws) + xoff // sub
    fast = isinstance(xoff, int) and xoff == 0
    if fast:
        # uniform CTB->sample expansion: broadcast-repeat + crop instead of
        # per-column gathers
        def expand(a):
            return jnp.broadcast_to(
                a[:, None, :, None], (nctby, ctbv, nctbx, ctb)) \
                .reshape(nctby * ctbv, nctbx * ctb)[:Hs, :Ws]
    else:
        ys_c = jnp.clip(jnp.arange(Hs) // ctbv, 0, nctby - 1)
        xs_c = jnp.clip(gx_plane // ctb, 0, nctbx - 1)

        def expand(a):
            return a[ys_c][:, xs_c]

    type_map = expand(t)
    eo_map = expand(eo)
    band_map = expand(band)
    off_maps = jnp.stack([expand(offs[:, :, k]) for k in range(4)], axis=0)

    # per-sample skip (pcm/tq-bypass) from the (strip-local) 4x4 grid
    if fast:
        og = grids["off"]
        fy, fx = 4 // subv, 4 // sub
        oh, ow = og.shape
        skip = jnp.broadcast_to(og[:, None, :, None], (oh, fy, ow, fx)) \
            .reshape(oh * fy, ow * fx)[:Hs, :Ws] != 0
    else:
        gy = (jnp.arange(Hs) * subv) >> 2
        gx = (jnp.arange(Ws) * sub) >> 2
        skip = grids["off"][gy][:, gx] != 0

    # neighbor availability: expand CTB-pair-ok to boundary samples
    pair_ok = grids["pair_ok"]                  # (4, nctby, nctbx) bool
    ys = jnp.arange(Hs)
    at_l = (gx_plane % ctb) == 0
    at_r = ((gx_plane % ctb) == (ctb - 1)) | \
        (gx_plane == (W // sub - 1))
    at_u = (ys % ctbv) == 0
    at_d = ((ys % ctbv) == (ctbv - 1)) | (ys == (Hs - 1))
    ok = [expand(pair_ok[k].astype(jnp.int8)) != 0 for k in range(4)]
    avail = jnp.stack([
        ~at_l[None, :] | ok[0],
        ~at_r[None, :] | ok[1],
        (~at_u[:, None]) | ok[2],
        (~at_d[:, None]) | ok[3],
    ])
    return type_map, eo_map, band_map, off_maps, skip, avail
