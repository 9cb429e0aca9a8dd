"""Deblocking filter reference implementation (spec 8.7.2) — numpy, bit-exact.

Capability counterpart of /root/reference/libde265/deblock.cc (edge marking,
boundary-strength derivation, luma normal/strong + chroma filters, V then H
two-pass structure). Operates whole-frame; the device backend parallelizes the
same math over CTB tiles.
"""
import numpy as np

from ..plan import MODE_INTRA

# beta' (spec Table 8-12), Q = 0..51
BETA_TABLE = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
    26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,
    58, 60, 62, 64,
)
# tc' (spec Table 8-12), Q = 0..53
TC_TABLE = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4,
    4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24,
)

CHROMA_QP_TABLE = (29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37)


def _clip3(lo, hi, v):
    return max(lo, min(hi, v))


def derive_bs(plan, x, y, vertical):
    """Boundary strength for the 4-sample edge segment whose top-left luma
    sample is (x,y) (spec 8.7.2.4). p = block before edge, q = after."""
    g = 4
    qx, qy = x >> 2, y >> 2
    if vertical:
        px, py = (x - 1) >> 2, y >> 2
    else:
        px, py = x >> 2, (y - 1) >> 2
    pm = plan.pred_mode
    if pm[py, px] == MODE_INTRA or pm[qy, qx] == MODE_INTRA:
        return 2
    # transform edge with nonzero coeffs
    tu_edge = bool(plan.tu_boundary[qy, qx] & (1 if vertical else 2)) or \
        bool(plan.cb_boundary[qy, qx] & (1 if vertical else 2))
    if tu_edge and (plan.cbf_luma[py, px] or plan.cbf_luma[qy, qx]):
        return 1
    # motion differences
    pf_p = plan.pred_flag[py, px]
    pf_q = plan.pred_flag[qy, qx]
    mv_p = plan.mv[py, px]
    mv_q = plan.mv[qy, qx]
    poc_p = plan.ref_poc[py, px]
    poc_q = plan.ref_poc[qy, qx]
    # collect (poc, mv) used by each side
    def refs(pf, poc, mv):
        out = []
        for l in range(2):
            if pf[l]:
                out.append((int(poc[l]), (int(mv[l][0]), int(mv[l][1]))))
        return out
    rp, rq = refs(pf_p, poc_p, mv_p), refs(pf_q, poc_q, mv_q)
    if len(rp) != len(rq):
        return 1
    if len(rp) == 1:
        (pocp, mvp), (pocq, mvq) = rp[0], rq[0]
        if pocp != pocq:
            return 1
        if abs(mvp[0] - mvq[0]) >= 4 or abs(mvp[1] - mvq[1]) >= 4:
            return 1
        return 0
    if len(rp) == 2:
        pocs_p = sorted(p for p, _ in rp)
        pocs_q = sorted(p for p, _ in rq)
        if pocs_p != pocs_q:
            return 1
        def far(a, b):
            return abs(a[0] - b[0]) >= 4 or abs(a[1] - b[1]) >= 4
        if rp[0][0] == rp[1][0]:  # both refs same picture: try both assignments
            if (far(rp[0][1], rq[0][1]) or far(rp[1][1], rq[1][1])) and \
               (far(rp[0][1], rq[1][1]) or far(rp[1][1], rq[0][1])):
                return 1
            return 0
        # distinct pictures: match by poc
        if rp[0][0] != rq[0][0]:
            rq = [rq[1], rq[0]]
        if far(rp[0][1], rq[0][1]) or far(rp[1][1], rq[1][1]):
            return 1
        return 0
    return 0


def _edge_enabled(plan, x, y, vertical, sh_map):
    """Filtering allowed across this edge (slice/tile/picture boundaries)."""
    if vertical and x == 0:
        return False
    if not vertical and y == 0:
        return False
    pps = plan.pps
    log2 = plan.sps.Log2CtbSizeY
    W = plan.sps.PicWidthInCtbsY
    if vertical:
        pxc, pyc = (x - 1) >> log2, y >> log2
    else:
        pxc, pyc = x >> log2, (y - 1) >> log2
    qxc, qyc = x >> log2, y >> log2
    if (pxc, pyc) != (qxc, qyc):
        if pps.TileId[qyc * W + qxc] != pps.TileId[pyc * W + pxc] and \
                not pps.loop_filter_across_tiles_enabled_flag:
            return False
        if plan.slice_addr_rs[qyc, qxc] != plan.slice_addr_rs[pyc, pxc]:
            sh = sh_map.get(int(plan.ctb_slice_seg[qyc, qxc]))
            if sh is not None and not sh.slice_loop_filter_across_slices_enabled_flag:
                return False
    return True


def _filters_off(plan, gx, gy):
    """True if the sample's CU bypasses loop filtering (pcm/tq-bypass)."""
    sps = plan.sps
    if plan.tq_bypass[gy, gx]:
        return True
    if plan.pcm_flag[gy, gx] and sps.pcm_loop_filter_disable_flag:
        return True
    return False


def deblock_frame(plan, planes):
    """Two passes: all vertical edges, then all horizontal (deblock.cc:1020)."""
    for vertical in (True, False):
        _deblock_pass(plan, planes, vertical)


def _deblock_pass(plan, planes, vertical):
    sps = plan.sps
    W, H = plan.W, plan.H
    bd = sps.BitDepthY
    sh_map = {int(sh.slice_segment_address): sh for sh in plan.slice_headers}

    def sh_for(x, y):
        seg = int(plan.ctb_slice_seg[y >> sps.Log2CtbSizeY, x >> sps.Log2CtbSizeY])
        return sh_map.get(seg, plan.slice_headers[0])

    Y = planes[0]
    # luma: edges on 8x8 grid, processed in 4-sample segments
    if vertical:
        xs = range(8, W, 8)
        for x in xs:
            for y in range(0, H, 4):
                self_edge = plan.tu_boundary[y >> 2, x >> 2] | \
                    plan.cb_boundary[y >> 2, x >> 2] | plan.pb_boundary[y >> 2, x >> 2]
                if not (self_edge & 1):
                    continue
                if not _edge_enabled(plan, x, y, True, sh_map):
                    continue
                sh = sh_for(x, y)
                if sh.slice_deblocking_filter_disabled_flag:
                    continue
                bs = derive_bs(plan, x, y, True)
                if bs == 0:
                    continue
                _filter_luma_segment(plan, Y, x, y, True, bs, sh, bd)
    else:
        for y in range(8, H, 8):
            for x in range(0, W, 4):
                self_edge = plan.tu_boundary[y >> 2, x >> 2] | \
                    plan.cb_boundary[y >> 2, x >> 2] | plan.pb_boundary[y >> 2, x >> 2]
                if not (self_edge & 2):
                    continue
                if not _edge_enabled(plan, x, y, False, sh_map):
                    continue
                sh = sh_for(x, y)
                if sh.slice_deblocking_filter_disabled_flag:
                    continue
                bs = derive_bs(plan, x, y, False)
                if bs == 0:
                    continue
                _filter_luma_segment(plan, Y, x, y, False, bs, sh, bd)

    # chroma: edges every 8 CHROMA samples (deblock.cc:738-757 —
    # 16-luma grid for 4:2:0/4:2:2 vertical, 8-luma for 4:4:4), bS==2
    if sps.ChromaArrayType == 0:
        return
    bd_c = sps.BitDepthC
    subw, subh = sps.SubWidthC, sps.SubHeightC
    for ci in (1, 2):
        C = planes[ci]
        cH, cW = C.shape
        if vertical:
            for x in range(8 * subw, W, 8 * subw):
                for y in range(0, H, 4):  # one 4-luma unit of edge
                    edge = plan.tu_boundary[y >> 2, x >> 2] | \
                        plan.cb_boundary[y >> 2, x >> 2]
                    if not (edge & 1):
                        continue
                    if not _edge_enabled(plan, x, y, True, sh_map):
                        continue
                    sh = sh_for(x, y)
                    if sh.slice_deblocking_filter_disabled_flag:
                        continue
                    if derive_bs(plan, x, y, True) != 2:
                        continue
                    _filter_chroma_segment(plan, C, ci, x // subw,
                                           y // subh, True, sh, bd_c)
        else:
            for y in range(8 * subh, H, 8 * subh):
                for x in range(0, W, 4):
                    edge = plan.tu_boundary[y >> 2, x >> 2] | \
                        plan.cb_boundary[y >> 2, x >> 2]
                    if not (edge & 2):
                        continue
                    if not _edge_enabled(plan, x, y, False, sh_map):
                        continue
                    sh = sh_for(x, y)
                    if sh.slice_deblocking_filter_disabled_flag:
                        continue
                    if derive_bs(plan, x, y, False) != 2:
                        continue
                    _filter_chroma_segment(plan, C, ci, x // subw,
                                           y // subh, False, sh, bd_c)


def _get_lines(img, x, y, vertical, nl=4, taps=4):
    """Return (nl, 2*taps) matrix: rows are lines crossing the edge;
    columns [p_taps-1 .. p0, q0 .. q_taps-1]."""
    out = np.zeros((nl, 2 * taps), np.int32)
    for i in range(nl):
        for t in range(taps):
            if vertical:
                out[i, taps - 1 - t] = img[y + i, x - 1 - t]
                out[i, taps + t] = img[y + i, x + t]
            else:
                out[i, taps - 1 - t] = img[y - 1 - t, x + i]
                out[i, taps + t] = img[y + t, x + i]
    return out


def _put_lines(img, x, y, vertical, vals, taps=4):
    nl = vals.shape[0]
    for i in range(nl):
        for t in range(taps):
            if vertical:
                img[y + i, x - 1 - t] = vals[i, taps - 1 - t]
                img[y + i, x + t] = vals[i, taps + t]
            else:
                img[y - 1 - t, x + i] = vals[i, taps - 1 - t]
                img[y + t, x + i] = vals[i, taps + t]


def _filter_luma_segment(plan, Y, x, y, vertical, bs, sh, bd):
    """spec 8.7.2.5.3/8.7.2.5.4/8.7.2.5.7 for one 4-line segment."""
    if vertical:
        qp_q = int(plan.qp_y[y >> 2, x >> 2])
        qp_p = int(plan.qp_y[y >> 2, (x - 1) >> 2])
    else:
        qp_q = int(plan.qp_y[y >> 2, x >> 2])
        qp_p = int(plan.qp_y[(y - 1) >> 2, x >> 2])
    qp_l = (qp_p + qp_q + 1) >> 1
    Qb = _clip3(0, 51, qp_l + sh.slice_beta_offset)
    beta = BETA_TABLE[Qb] << (bd - 8)
    Qt = _clip3(0, 53, qp_l + 2 * (bs - 1) + sh.slice_tc_offset)
    tc = TC_TABLE[Qt] << (bd - 8)
    if tc == 0 and beta == 0:
        return
    L = _get_lines(Y, x, y, vertical)  # (4, 8): [p3 p2 p1 p0 q0 q1 q2 q3]
    p = L[:, 3::-1]  # p[i][k] = p_k of line i
    q = L[:, 4:]
    dp0 = abs(p[0, 2] - 2 * p[0, 1] + p[0, 0])
    dp3 = abs(p[3, 2] - 2 * p[3, 1] + p[3, 0])
    dq0 = abs(q[0, 2] - 2 * q[0, 1] + q[0, 0])
    dq3 = abs(q[3, 2] - 2 * q[3, 1] + q[3, 0])
    d = dp0 + dp3 + dq0 + dq3
    if d >= beta:
        return
    # pcm / bypass per side
    if vertical:
        p_off = _filters_off(plan, (x - 1) >> 2, y >> 2)
        q_off = _filters_off(plan, x >> 2, y >> 2)
    else:
        p_off = _filters_off(plan, x >> 2, (y - 1) >> 2)
        q_off = _filters_off(plan, x >> 2, y >> 2)

    def strong_line(i):
        return (2 * (([dp0, 0, 0, dp3][i]) + ([dq0, 0, 0, dq3][i])) < (beta >> 2) and
                abs(p[i, 3] - p[i, 0]) + abs(q[i, 0] - q[i, 3]) < (beta >> 3) and
                abs(p[i, 0] - q[i, 0]) < ((5 * tc + 1) >> 1))
    strong = strong_line(0) and strong_line(3)
    maxv = (1 << bd) - 1
    out = L.copy()
    if strong:
        for i in range(4):
            pi, qi = p[i], q[i]
            np0 = _clip3(pi[0] - 2 * tc, pi[0] + 2 * tc,
                         (pi[2] + 2 * pi[1] + 2 * pi[0] + 2 * qi[0] + qi[1] + 4) >> 3)
            np1 = _clip3(pi[1] - 2 * tc, pi[1] + 2 * tc,
                         (pi[2] + pi[1] + pi[0] + qi[0] + 2) >> 2)
            np2 = _clip3(pi[2] - 2 * tc, pi[2] + 2 * tc,
                         (2 * pi[3] + 3 * pi[2] + pi[1] + pi[0] + qi[0] + 4) >> 3)
            nq0 = _clip3(qi[0] - 2 * tc, qi[0] + 2 * tc,
                         (pi[1] + 2 * pi[0] + 2 * qi[0] + 2 * qi[1] + qi[2] + 4) >> 3)
            nq1 = _clip3(qi[1] - 2 * tc, qi[1] + 2 * tc,
                         (pi[0] + qi[0] + qi[1] + qi[2] + 2) >> 2)
            nq2 = _clip3(qi[2] - 2 * tc, qi[2] + 2 * tc,
                         (pi[0] + qi[0] + qi[1] + 3 * qi[2] + 2 * qi[3] + 4) >> 3)
            if not p_off:
                out[i, 3], out[i, 2], out[i, 1] = np0, np1, np2
            if not q_off:
                out[i, 4], out[i, 5], out[i, 6] = nq0, nq1, nq2
    else:
        dEp = (dp0 + dp3) < ((beta + (beta >> 1)) >> 3)
        dEq = (dq0 + dq3) < ((beta + (beta >> 1)) >> 3)
        for i in range(4):
            pi, qi = p[i], q[i]
            delta = (9 * (qi[0] - pi[0]) - 3 * (qi[1] - pi[1]) + 8) >> 4
            if abs(delta) >= tc * 10:
                continue
            delta = _clip3(-tc, tc, delta)
            if not p_off:
                out[i, 3] = _clip3(0, maxv, pi[0] + delta)
            if not q_off:
                out[i, 4] = _clip3(0, maxv, qi[0] - delta)
            if dEp and not p_off:
                dp = _clip3(-(tc >> 1), tc >> 1,
                            (((pi[2] + pi[0] + 1) >> 1) - pi[1] + delta) >> 1)
                out[i, 2] = _clip3(0, maxv, pi[1] + dp)
            if dEq and not q_off:
                dq = _clip3(-(tc >> 1), tc >> 1,
                            (((qi[2] + qi[0] + 1) >> 1) - qi[1] - delta) >> 1)
                out[i, 5] = _clip3(0, maxv, qi[1] + dq)
    np.clip(out, 0, maxv, out=out)
    _put_lines(Y, x, y, vertical, out)


def _filter_chroma_segment(plan, C, ci, cx, cy, vertical, sh, bd):
    """spec 8.7.2.5.5 chroma filter for a 4-line (chroma) segment at (cx,cy)."""
    pps = plan.pps
    sps = plan.sps
    # luma coords of the two sides
    lx, ly = cx * sps.SubWidthC, cy * sps.SubHeightC
    if vertical:
        qp_q = int(plan.qp_y[ly >> 2, lx >> 2])
        qp_p = int(plan.qp_y[ly >> 2, (lx - 1) >> 2])
        p_off = _filters_off(plan, (lx - 1) >> 2, ly >> 2)
        q_off = _filters_off(plan, lx >> 2, ly >> 2)
    else:
        qp_q = int(plan.qp_y[ly >> 2, lx >> 2])
        qp_p = int(plan.qp_y[(ly - 1) >> 2, lx >> 2])
        p_off = _filters_off(plan, lx >> 2, (ly - 1) >> 2)
        q_off = _filters_off(plan, lx >> 2, ly >> 2)
    qp_off = pps.pic_cb_qp_offset if ci == 1 else pps.pic_cr_qp_offset
    qpi = _clip3(0, 57, ((qp_p + qp_q + 1) >> 1) + qp_off)
    if sps.ChromaArrayType == 1:
        qpc = qpi if qpi < 30 else (qpi - 6 if qpi > 43 else CHROMA_QP_TABLE[qpi - 30])
    else:
        qpc = min(qpi, 51)
    Qt = _clip3(0, 53, qpc + 2 + sh.slice_tc_offset)
    tc = TC_TABLE[Qt] << (bd - 8)
    if tc == 0:
        return
    maxv = (1 << bd) - 1
    # one 4-luma-sample edge segment in chroma lines/columns
    nl = 4 // (sps.SubHeightC if vertical else sps.SubWidthC)
    L = _get_lines(C, cx, cy, vertical, nl=nl, taps=2)  # [p1 p0 q0 q1]
    out = L.copy()
    for i in range(nl):
        p1, p0, q0, q1 = L[i]
        delta = _clip3(-tc, tc, ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3))
        if not p_off:
            out[i, 1] = _clip3(0, maxv, p0 + delta)
        if not q_off:
            out[i, 2] = _clip3(0, maxv, q0 - delta)
    _put_lines(C, cx, cy, vertical, out, taps=2)
