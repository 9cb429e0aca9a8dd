"""Frame reconstruction from a FramePlan: intra prediction replay, residual
add, inter MC hookup, deblocking and SAO.

This is the *reference backend* (numpy, bit-exact, serial TU replay in z-scan
order). The device backend consumes the same FramePlan but batches
TUs into wavefront levels; this module doubles as its differential-test oracle,
replicating the role of the scalar fallback kernels in the reference
(/root/reference/libde265/fallback*.cc).

Call stacks mirrored: decode_TU -> scale_coefficients (transform.cc:352-625),
decode_intra_prediction (intrapred.cc:1074-1164), apply_deblocking_filter
(deblock.cc:1020-1058), apply_sample_adaptive_offset (sao.cc:276-395).
"""
import numpy as np

from .plan import FramePlan, MODE_INTRA
from .ops import transform_ref, intra_ref


def clip3(lo, hi, v):
    return np.clip(v, lo, hi)


class Availability:
    """z-scan availability (spec 6.4.1) over FramePlan metadata."""

    def __init__(self, plan: FramePlan):
        self.plan = plan
        self.pps = plan.pps
        self.sps = plan.sps
        self.ctb_log2 = plan.sps.Log2CtbSizeY
        self.W = plan.W
        self.H = plan.H
        self.wctb = plan.sps.PicWidthInCtbsY

    def available(self, x_curr, y_curr, x_nb, y_nb):
        if x_nb < 0 or y_nb < 0 or x_nb >= self.W or y_nb >= self.H:
            return False
        log2 = self.ctb_log2
        rs_c = (y_curr >> log2) * self.wctb + (x_curr >> log2)
        rs_n = (y_nb >> log2) * self.wctb + (x_nb >> log2)
        ts_c = self.pps.CtbAddrRStoTS[rs_c]
        ts_n = self.pps.CtbAddrRStoTS[rs_n]
        if ts_n > ts_c:
            return False
        if ts_n == ts_c:
            if self._z(x_nb, y_nb) >= self._z(x_curr, y_curr):
                return False
        sa = self.plan.slice_addr_rs
        if sa[rs_n // self.wctb, rs_n % self.wctb] != sa[rs_c // self.wctb, rs_c % self.wctb]:
            return False
        if self.pps.TileId[rs_n] != self.pps.TileId[rs_c]:
            return False
        return True

    def _z(self, x, y):
        size = 1 << self.ctb_log2
        xr = (x & (size - 1)) >> 2
        yr = (y & (size - 1)) >> 2
        z = 0
        for b in range(8):
            z |= ((xr >> b) & 1) << (2 * b)
            z |= ((yr >> b) & 1) << (2 * b + 1)
        return z


def gather_border(plan: FramePlan, planes, avail: Availability,
                  x, y, log2, cidx, bitdepth):
    """spec 8.4.4.2.2: build the 4N+1 border array with substitution.
    (x, y) are in the plane's own sample units."""
    n = 1 << log2
    # per-axis subsampling (4:2:2 halves only horizontally)
    sub_x = 1 if cidx == 0 else plan.sps.SubWidthC
    sub_y = 1 if cidx == 0 else plan.sps.SubHeightC
    xL, yL = x * sub_x, y * sub_y   # luma coords of block origin
    pl = planes[cidx]
    H, W = pl.shape
    ref = np.zeros(4 * n + 1, np.int32)
    ok = np.zeros(4 * n + 1, bool)
    cip = plan.pps.constrained_intra_pred_flag
    c = 2 * n

    def sample_ok(sx, sy):
        # sx, sy in this plane's units
        lx, ly = sx * sub_x, sy * sub_y
        if not avail.available(xL, yL, lx, ly):
            return False
        if cip and plan.pred_mode[ly >> 2, lx >> 2] != MODE_INTRA:
            return False
        return True

    # left column: k=1..2n -> p[-1][k-1] at (x-1, y+k-1); index c-k
    # (availability is cached per underlying 4x4 LUMA block row)
    if x > 0:
        prev = None
        last_blk = None
        for k in range(1, 2 * n + 1):
            sy = y + k - 1
            if sy >= H:
                ok[c - k] = False
                continue
            blk = (sy * sub_y) >> 2
            if prev is None or blk != last_blk:
                prev = sample_ok(x - 1, sy)
                last_blk = blk
            ok[c - k] = prev
            if prev:
                ref[c - k] = pl[sy, x - 1]
    # corner
    if x > 0 and y > 0:
        if sample_ok(x - 1, y - 1):
            ok[c] = True
            ref[c] = pl[y - 1, x - 1]
    # top row: k=1..2n -> p[k-1][-1] at (x+k-1, y-1); index c+k
    if y > 0:
        prev = None
        last_blk = None
        for k in range(1, 2 * n + 1):
            sx = x + k - 1
            if sx >= W:
                ok[c + k] = False
                continue
            blk = (sx * sub_x) >> 2
            if prev is None or blk != last_blk:
                prev = sample_ok(sx, y - 1)
                last_blk = blk
            ok[c + k] = prev
            if prev:
                ref[c + k] = pl[y - 1, sx]

    if not ok.any():
        ref[:] = 1 << (bitdepth - 1)
        return ref
    if ok.all():
        return ref
    # substitution: scan index 0 (bottom-left) .. 4n (top-right)
    if not ok[0]:
        first = int(np.argmax(ok))
        ref[0] = ref[first]
        ok[0] = True
    for i in range(1, 4 * n + 1):
        if not ok[i]:
            ref[i] = ref[i - 1]
    return ref


def reconstruct_frame(plan: FramePlan, dpb_images=None):
    """Decode all TUs/PUs of a frame into pixel planes (pre-loop-filter),
    then apply deblocking + SAO. Returns [Y, Cb, Cr] uint8/uint16 planes."""
    sps = plan.sps
    bd_y, bd_c = sps.BitDepthY, sps.BitDepthC
    dt = np.uint8 if max(bd_y, bd_c) == 8 else np.uint16
    W, H = plan.W, plan.H
    cw, ch = ((W // sps.SubWidthC, H // sps.SubHeightC)
              if sps.ChromaArrayType != 0 else (0, 0))
    planes = [np.zeros((H, W), dt), np.zeros((ch, cw), dt), np.zeros((ch, cw), dt)]
    avail = Availability(plan)

    # Pass 1: inter prediction (MC) for all PUs
    if plan.pus:
        from .ops.inter_ref import motion_compensate_frame
        motion_compensate_frame(plan, planes, dpb_images)

    # Pass 2: TU replay in z-scan decode order
    scaling = plan.pps.scaling_list if plan.pps.pic_scaling_list_data_present_flag \
        else (sps.scaling_list if sps.scaling_list_enable_flag else None)
    resid_luma = None
    for tu in plan.tus:
        if tu.cidx == -1:  # PCM paste
            n = 1 << tu.log2
            planes[0][tu.y:tu.y + n, tu.x:tu.x + n] = tu.pcm_y
            if sps.ChromaArrayType != 0:
                cw_, ch_ = n // sps.SubWidthC, n // sps.SubHeightC
                cx0, cy0 = tu.x // sps.SubWidthC, tu.y // sps.SubHeightC
                planes[1][cy0:cy0 + ch_, cx0:cx0 + cw_] = tu.pcm_c[0]
                planes[2][cy0:cy0 + ch_, cx0:cx0 + cw_] = tu.pcm_c[1]
            continue
        n = 1 << tu.log2
        bd = bd_y if tu.cidx == 0 else bd_c
        maxv = (1 << bd) - 1
        if tu.pred_mode == MODE_INTRA:
            ref = gather_border(plan, planes, avail, tu.x, tu.y, tu.log2, tu.cidx, bd)
            if sps.intra_smoothing_disabled_flag:
                fref = ref     # range ext: no [1,2,1]/strong smoothing
            else:
                fref = intra_ref.filter_border(
                    ref, n, tu.intra_mode, tu.cidx, bd,
                    bool(sps.strong_intra_smoothing_enable_flag),
                    c444=sps.ChromaArrayType == 3)
            pred = intra_ref.predict(
                fref, tu.intra_mode, tu.log2, tu.cidx, bd,
                disable_boundary_filter=bool(getattr(sps, "implicit_rdpcm_enabled_flag", 0))
                and tu.tq_bypass)
        else:
            pred = planes[tu.cidx][tu.y:tu.y + n, tu.x:tu.x + n].astype(np.int32)

        # range-ext residual modes (reference decode_TU, slice.cc:3424-3466)
        skip_or_byp = tu.tq_bypass or tu.transform_skip
        if tu.pred_mode == MODE_INTRA:
            rdpcm = 0
            if sps.implicit_rdpcm_enabled_flag and skip_or_byp and \
                    tu.intra_mode in (10, 26):
                rdpcm = 1 if tu.intra_mode == 10 else 2
        else:
            rdpcm = tu.explicit_rdpcm if tu.explicit_rdpcm > 0 else 0
        rotate = bool(sps.transform_skip_rotation_enabled_flag) and \
            tu.log2 == 2 and tu.pred_mode == MODE_INTRA and skip_or_byp

        ccp_on = bool(plan.pps.cross_component_prediction_enabled_flag)
        res = None
        if tu.coeffs is not None:
            smat = sdc = None
            if scaling is not None:
                smat, sdc = _scaling_matrix(scaling, tu.log2, tu.cidx,
                                            tu.pred_mode == MODE_INTRA)
            is_dst = (tu.cidx == 0 and tu.log2 == 2 and tu.pred_mode == MODE_INTRA)
            res = transform_ref.scale_and_inv_transform(
                tu.coeffs, tu.qp, tu.log2, is_dst, tu.transform_skip,
                tu.tq_bypass, bd, smat, sdc, rdpcm=rdpcm, rotate=rotate)
        if tu.cidx == 0 and ccp_on:
            # keep the luma residual for cross-component prediction of the
            # co-located chroma TUs (4:4:4; transform.cc:235-251)
            resid_luma = res if res is not None else \
                np.zeros((n, n), np.int32)
        if tu.cidx != 0 and tu.cross_comp_alpha:
            if res is None:
                res = np.zeros((n, n), np.int32)
            rl = resid_luma[:n, :n].astype(np.int64)
            res = res + ((tu.cross_comp_alpha *
                          ((rl << bd_c) >> bd_y)) >> 3)
        if res is not None:
            out = np.clip(pred + res, 0, maxv)
        else:
            out = np.clip(pred, 0, maxv)
        planes[tu.cidx][tu.y:tu.y + n, tu.x:tu.x + n] = out.astype(dt)

    plan.planes = planes
    # Loop filters: gate per-frame on *any* slice enabling the filter; the
    # per-CTB slice-header lookup inside the filters handles mixed flags
    # (reference: per-CTB lookup, deblock.cc:1020-1058). The debug
    # kill-switches mirror dec265 --disable-deblocking/--disable-sao
    # (dec265.cc:598-609).
    import os
    shs = plan.slice_headers or []
    if os.environ.get("DE265_DISABLE_DEBLOCK", "0") == "0" and \
            any(not sh.slice_deblocking_filter_disabled_flag for sh in shs):
        from .ops.deblock_ref import deblock_frame
        deblock_frame(plan, planes)
    if os.environ.get("DE265_DISABLE_SAO", "0") == "0" and \
            any(sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag
                for sh in shs):
        from .ops.sao_ref import sao_frame
        planes = sao_frame(plan, planes)
        plan.planes = planes
    return planes


def _scaling_matrix(sl, log2, cidx, is_intra):
    """Expand the coded scaling list to (n,n) for this TU (spec 7.4.5)."""
    n = 1 << log2
    midx = (0 if is_intra else 3) + cidx
    if log2 == 2:
        m = np.array(sl.m4[midx], np.int32).reshape(4, 4)
        return m, None
    if log2 == 3:
        return np.array(sl.m8[midx], np.int32).reshape(8, 8), None
    if log2 == 4:
        base = np.array(sl.m16[midx], np.int32).reshape(8, 8)
        return np.repeat(np.repeat(base, 2, 0), 2, 1), sl.dc16[midx]
    midx32 = 0 if is_intra else 1
    base = np.array(sl.m32[midx32], np.int32).reshape(8, 8)
    return np.repeat(np.repeat(base, 4, 0), 4, 1), sl.dc32[midx32]
