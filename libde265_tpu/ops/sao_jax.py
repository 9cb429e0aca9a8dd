"""Whole-frame vectorized SAO (JAX/XLA), bit-exact (spec 8.7.3).

Design: instead of per-CTB tasks with row sync
(/root/reference/libde265/sao.cc:396-518), the per-CTB parameters are
broadcast to per-sample dense maps on the host, and the device applies band
and edge offsets to the whole frame at once, out-of-place (the reference also
works out-of-place into a second image, sao.cc:480-516).
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def plan_sao_maps(plan, cidx):
    """Host: expand per-CTB SAO params to per-sample maps for plane cidx.
    Returns (type_map, eo_map, band_pos_map, offsets_map(4), skip_map,
    allow_left/right/up/down maps) or None if SAO is entirely off."""
    sps, pps = plan.sps, plan.pps
    subw = 1 if cidx == 0 else sps.SubWidthC
    subh = 1 if cidx == 0 else sps.SubHeightC
    H = plan.H // subh
    W = plan.W // subw
    ctbw = sps.CtbSizeY // subw
    ctbh = sps.CtbSizeY // subh
    sh_map = {int(s.slice_segment_address): s for s in plan.slice_headers}

    t = plan.sao.type_idx[:, :, cidx]
    if not t.any():
        return None
    nctby, nctbx = plan.nctby, plan.nctbx
    # per-CTB slice-level enables
    enable = np.zeros((nctby, nctbx), bool)
    for cy in range(nctby):
        for cx in range(nctbx):
            sh = sh_map.get(int(plan.ctb_slice_seg[cy, cx]))
            if sh is None:
                continue
            enable[cy, cx] = sh.slice_sao_luma_flag if cidx == 0 else \
                sh.slice_sao_chroma_flag

    def expand(a):
        full = np.repeat(np.repeat(a, ctbh, 0), ctbw, 1)
        return full[:H, :W]

    type_map = expand(np.where(enable, t, 0))
    eo_map = expand(plan.sao.eo_class[:, :, cidx])
    band_map = expand(plan.sao.band_pos[:, :, cidx])
    off_maps = np.stack([expand(plan.sao.offsets[:, :, cidx, k])
                         for k in range(4)], axis=0)
    # per-sample skip (pcm/tq-bypass)
    gy = (np.arange(H) * subh) >> 2
    gx = (np.arange(W) * subw) >> 2
    tq = plan.tq_bypass[np.ix_(gy, gx)] > 0
    skip = tq
    if sps.pcm_loop_filter_disable_flag:
        skip = skip | (plan.pcm_flag[np.ix_(gy, gx)] > 0)
    # neighbor-availability: across tile/slice boundaries when filters off.
    # Build per-sample "neighbor sample usable" via CTB-level checks expanded.
    avail = _neighbor_avail_maps(plan, sh_map, cidx, H, W, ctbh, ctbw)
    return type_map, eo_map, band_map, off_maps, skip, avail


def _neighbor_avail_maps(plan, sh_map, cidx, H, W, ctbh, ctbw):
    """(4,H,W) bool: neighbor at left/right/up/down direction allowed.
    Only CTB-boundary samples can be blocked (tile/slice rules)."""
    pps = plan.pps
    nctby, nctbx = plan.nctby, plan.nctbx
    tid = np.asarray(pps.TileId).reshape(nctby, nctbx)
    sa = plan.slice_addr_rs

    def ctb_pair_ok(cy, cx, ny, nx):
        if nx < 0 or ny < 0 or nx >= nctbx or ny >= nctby:
            return False
        if tid[cy, cx] != tid[ny, nx] and not pps.loop_filter_across_tiles_enabled_flag:
            return False
        if sa[cy, cx] != sa[ny, nx]:
            sh = sh_map.get(int(plan.ctb_slice_seg[cy, cx]))
            shn = sh_map.get(int(plan.ctb_slice_seg[ny, nx]))
            for s in (sh, shn):
                if s is not None and not s.slice_loop_filter_across_slices_enabled_flag:
                    return False
        return True

    out = np.ones((4, H, W), bool)
    # directions: 0 left, 1 right, 2 up, 3 down
    for cy in range(nctby):
        for cx in range(nctbx):
            y0, y1 = cy * ctbh, min((cy + 1) * ctbh, H)
            x0, x1 = cx * ctbw, min((cx + 1) * ctbw, W)
            if x0 < W and not ctb_pair_ok(cy, cx, cy, cx - 1):
                out[0, y0:y1, x0] = False
            if x1 - 1 < W and not ctb_pair_ok(cy, cx, cy, cx + 1):
                out[1, y0:y1, x1 - 1] = False
            if y0 < H and not ctb_pair_ok(cy, cx, cy - 1, cx):
                out[2, y0, x0:x1] = False
            if y1 - 1 < H and not ctb_pair_ok(cy, cx, cy + 1, cx):
                out[3, y1 - 1, x0:x1] = False
    # picture boundary
    out[0, :, 0] = False
    out[1, :, W - 1] = False
    out[2, 0, :] = False
    out[3, H - 1, :] = False
    return out


@partial(jax.jit, static_argnames=("bitdepth",))
def sao_apply(src, type_map, eo_map, band_map, off_maps, skip, avail,
              bitdepth=8):
    """src: (H,W) int32. Applies band+edge SAO, returns new plane.

    Select-first formulation: the two EO neighbors are chosen per pixel
    by eo_map BEFORE the sign/category math, so sign/eidx/offset run
    once instead of once per class (the previous 4-class loop cost ~40
    full-plane passes; this is ~25). Neighbors come from ONE zero-padded
    plane via static slices (borders are masked by avail, so the pad
    value never reaches the output)."""
    H, W = src.shape
    maxv = (1 << bitdepth) - 1
    shift = bitdepth - 5
    x = src

    # ---- band offset
    band = (x >> shift)
    delta_b = jnp.zeros_like(x)
    for k in range(4):
        delta_b = jnp.where(band == ((band_map + k) & 31), off_maps[k], delta_b)

    # ---- edge offset
    xp = jnp.pad(x, 1)

    def nb(dy, dx):
        return xp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    def sel4(v0, v1, v2, v3):
        return jnp.where(eo_map == 0, v0,
                         jnp.where(eo_map == 1, v1,
                                   jnp.where(eo_map == 2, v2, v3)))

    # class0 horiz: a=left,b=right; class1 vert: a=up,b=down;
    # class2 135deg: a=up-left,b=down-right; class3 45deg: a=up-right,b=down-left
    a = sel4(nb(0, -1), nb(-1, 0), nb(-1, -1), nb(-1, 1))
    b = sel4(nb(0, 1), nb(1, 0), nb(1, 1), nb(1, -1))
    eidx = jnp.sign(x - a) + jnp.sign(x - b)
    d = jnp.where(eidx == -2, off_maps[0],
                  jnp.where(eidx == -1, off_maps[1],
                            jnp.where(eidx == 1, off_maps[2],
                                      jnp.where(eidx == 2, off_maps[3], 0))))
    # per-class availability (classes 2/3 need all four directions)
    ok_h = avail[0] & avail[1]
    ok_v = avail[2] & avail[3]
    ok = jnp.where(eo_map == 0, ok_h,
                   jnp.where(eo_map == 1, ok_v, ok_h & ok_v))
    delta_e = jnp.where(ok, d, 0)

    delta = jnp.where(type_map == 1, delta_b,
                      jnp.where(type_map == 2, delta_e, 0))
    delta = jnp.where(skip, 0, delta)
    return jnp.clip(x + delta, 0, maxv)


def sao_frame_jax(plan, planes):
    """Drop-in replacement for sao_ref.sao_frame using the device."""
    out = []
    for ci in range(3):
        maps = plan_sao_maps(plan, ci)
        if maps is None:
            out.append(planes[ci].copy())
            continue
        t, eo, bp, offs, skip, avail = maps
        bd = plan.sps.BitDepthY if ci == 0 else plan.sps.BitDepthC
        res = sao_apply(jnp.asarray(planes[ci], jnp.int32), jnp.asarray(t),
                        jnp.asarray(eo), jnp.asarray(bp), jnp.asarray(offs),
                        jnp.asarray(skip), jnp.asarray(avail), bitdepth=bd)
        out.append(np.asarray(res).astype(planes[ci].dtype))
    return out
