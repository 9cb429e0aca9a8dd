"""Batched intra prediction on the device — bit-exact (spec 8.4.4.2).

Wavefront execution: the host assigns each intra TU a dependency level
(intra_wavefront.py); all TUs of a level are independent and run as one
batched device step per (log2, plane-class) bucket.

Division of labor:
  host   — border sample coordinates, availability, substitution source
           indices, angular refbuf gather maps (all derivable from metadata)
  device — pixel gathers, [1,2,1]/strong smoothing, planar/DC/angular math,
           boundary filters, residual add, scatter back into the plane

Batch sizes are padded to powers of two to bound the number of compiled
shapes (each new shape is a compile).
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .intra_ref import INTRA_PRED_ANGLE, INV_ANGLE
from ..plan import MODE_INTRA

ANGLE_ARR = np.asarray(INTRA_PRED_ANGLE, np.int32)        # modes 2..34


def _pad(n):
    p = 8
    while p < n:
        p <<= 1
    return p


def host_border_info(plan, avail, tus, cidx, log2, bitdepth):
    """For each TU: (by, bx) gather coords (4n+1), substitution src index,
    all-unavailable flag. Mirrors reconstruct.gather_border's host logic."""
    n = 1 << log2
    L = 4 * n + 1
    c = 2 * n
    subw = 1 if cidx == 0 else plan.sps.SubWidthC
    subh = 1 if cidx == 0 else plan.sps.SubHeightC
    N = len(tus)
    by = np.zeros((N, L), np.int32)
    bx = np.zeros((N, L), np.int32)
    ok = np.zeros((N, L), bool)
    H = plan.H // subh
    W = plan.W // subw
    cip = plan.pps.constrained_intra_pred_flag
    pm = plan.pred_mode
    for t, tu in enumerate(tus):
        x, y = tu.x, tu.y
        # linear index i: 0..2n-1 left col bottom-up, 2n corner, 2n+1.. top
        # left column samples: index c-k -> (x-1, y+k-1)
        for k in range(1, 2 * n + 1):
            sy = y + k - 1
            i = c - k
            if x > 0 and sy < H:
                by[t, i] = sy; bx[t, i] = x - 1
                ok[t, i] = avail.available(x * subw, y * subh,
                                           (x - 1) * subw, sy * subh)
                if ok[t, i] and cip and pm[(sy * subh) >> 2, ((x - 1) * subw) >> 2] != MODE_INTRA:
                    ok[t, i] = False
        if x > 0 and y > 0:
            by[t, c] = y - 1; bx[t, c] = x - 1
            ok[t, c] = avail.available(x * subw, y * subh,
                                       (x - 1) * subw, (y - 1) * subh)
            if ok[t, c] and cip and pm[((y - 1) * subh) >> 2, ((x - 1) * subw) >> 2] != MODE_INTRA:
                ok[t, c] = False
        for k in range(1, 2 * n + 1):
            sx = x + k - 1
            i = c + k
            if y > 0 and sx < W:
                by[t, i] = y - 1; bx[t, i] = sx
                ok[t, i] = avail.available(x * subw, y * subh,
                                           sx * subw, (y - 1) * subh)
                if ok[t, i] and cip and pm[((y - 1) * subh) >> 2, (sx * subw) >> 2] != MODE_INTRA:
                    ok[t, i] = False
    # substitution source index per position (scan order = linear index)
    idx = np.arange(L)[None, :].repeat(N, 0)
    valid_idx = np.where(ok, idx, -1)
    ffill = np.maximum.accumulate(valid_idx, axis=1)
    any_ok = ok.any(axis=1)
    first_ok = np.where(any_ok, ok.argmax(axis=1), 0)
    src = np.where(ffill >= 0, ffill, first_ok[:, None])
    return by, bx, src, ~any_ok


def predict_core(ref, modes, log2, luma, bitdepth, strong, smooth):
    """Border filtering (8.4.4.2.3) + 35-mode prediction (8.4.4.2.4-6)
    from an already-substituted border array. ref: (N, 4n+1) int32 in
    bottom-left..top-right scan order (corner at index 2n); modes: (N,)
    int32. luma gates the DC/mode-10/26 boundary filters (cIdx==0 only,
    intrapred.cc:1058-1070); smooth gates [1,2,1]/strong filtering
    (cIdx==0 or 4:4:4). Returns (N, n, n) int32 prediction. Shared by the
    hybrid wavefront path (predict_level) and the fused in-program intra
    scan (frame_program) so both stay bit-exact by construction."""
    n = 1 << log2
    L = 4 * n + 1
    c = 2 * n
    N = ref.shape[0]
    maxv = (1 << bitdepth) - 1
    if smooth and n >= 8:
        md = jnp.minimum(jnp.abs(modes - 26), jnp.abs(modes - 10))
        thresh = {8: 7, 16: 1, 32: 0}[n]
        fflag = (modes != 1) & (md > thresh)
        # strong smoothing (luma n==32 only, intrapred.cc:848)
        if strong and n == 32 and luma:
            bt = 1 << (bitdepth - 5)
            condT = jnp.abs(ref[:, c] + ref[:, c + 2 * n] - 2 * ref[:, c + n]) < bt
            condL = jnp.abs(ref[:, c] + ref[:, c - 2 * n] - 2 * ref[:, c - n]) < bt
            sflag = fflag & condT & condL
        else:
            sflag = jnp.zeros((N,), bool)
        # [1,2,1]
        f121 = jnp.concatenate([
            ref[:, :1],
            (ref[:, :-2] + 2 * ref[:, 1:-1] + ref[:, 2:] + 2) >> 2,
            ref[:, -1:]], axis=1)
        # strong bilinear
        i_arr = jnp.abs(jnp.arange(L) - c)                 # distance from corner
        side_top = jnp.arange(L) > c
        corner = ref[:, c][:, None]
        top_end = ref[:, c + 2 * n][:, None]
        left_end = ref[:, c - 2 * n][:, None]
        endv = jnp.where(side_top[None, :], top_end, left_end)
        bil = ((2 * n - i_arr)[None, :] * corner + i_arr[None, :] * endv + n) >> 6
        bil = jnp.where((i_arr == 0) | (i_arr == 2 * n), ref, bil)
        ref = jnp.where(sflag[:, None], bil,
                        jnp.where(fflag[:, None], f121, ref))

    # ---- prediction
    # planar
    left = ref[:, c - 1 - jnp.arange(n)]                    # (N,n) p[-1][y]
    top = ref[:, c + 1 + jnp.arange(n)]                     # (N,n) p[x][-1]
    tr = ref[:, c + n + 1][:, None, None]
    bl = ref[:, c - n - 1][:, None, None]
    xg = jnp.arange(n)[None, None, :]
    yg = jnp.arange(n)[None, :, None]
    planar = ((n - 1 - xg) * left[:, :, None]
              + (xg + 1) * tr
              + (n - 1 - yg) * top[:, None, :]
              + (yg + 1) * bl + n) >> (int(np.log2(n)) + 1)
    # DC
    dc = (top.sum(1) + left.sum(1) + n) >> (int(np.log2(n)) + 1)
    dcp = jnp.broadcast_to(dc[:, None, None], (N, n, n))
    if luma and n < 32:
        row0 = (top + 3 * dc[:, None] + 2) >> 2
        col0 = (left + 3 * dc[:, None] + 2) >> 2
        corner00 = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2
        dcp = dcp.at[:, 0, :].set(row0)
        dcp = dcp.at[:, :, 0].set(col0)
        dcp = dcp.at[:, 0, 0].set(corner00)
    # angular: build refbuf for vertical-ish orientation; horizontal modes
    # use the mirrored ref (left column as "top") and transpose at the end.
    ang = jnp.asarray(ANGLE_ARR)[jnp.clip(modes - 2, 0, 32)]
    is_vert = modes >= 18
    # main side ref: for vertical: indices c..c+2n ; horizontal: c..c-2n
    steps = jnp.arange(2 * n + 1)
    main_idx = jnp.where(is_vert[:, None], c + steps[None, :], c - steps[None, :])
    mainref = jnp.take_along_axis(ref, main_idx, axis=1)    # (N, 2n+1)
    # projection side ref index for i=-1..-n:
    # vertical: ref[c - ((i*inv+128)>>8)]; horizontal: ref[c + (...)]
    inv_arr = np.zeros(35, np.int32)
    for m in range(11, 26):
        inv_arr[m] = INV_ANGLE[m - 11]
    inv = jnp.asarray(inv_arr)[jnp.clip(modes, 0, 34)]
    ineg = jnp.arange(1, n + 1)                             # i = -1..-n magnitude
    projoff = ((-ineg[None, :]) * inv[:, None] + 128) >> 8  # (N,n)
    proj_idx = jnp.where(is_vert[:, None], c - projoff, c + projoff)
    proj_idx = jnp.clip(proj_idx, 0, L - 1)
    projref = jnp.take_along_axis(ref, proj_idx, axis=1)    # (N,n) for i=-1..-n
    # refbuf[n + i], i in -n..2n: concat reversed proj + main
    refbuf = jnp.concatenate([projref[:, ::-1], mainref], axis=1)  # (N, 3n+1)
    refbuf = jnp.concatenate([refbuf, refbuf[:, -1:]], axis=1)     # +1 slack
    # prediction (in "main" orientation): rows j=1..n, cols k=0..n-1
    jrow = jnp.arange(1, n + 1)[None, :, None]              # (N?,n,1)
    pos = jrow * ang[:, None, None]
    idx = (pos >> 5)
    fact = pos & 31
    kcol = jnp.arange(n)[None, None, :]
    gi = n + kcol + idx + 1                                  # index into refbuf
    gi = jnp.clip(gi, 0, 3 * n + 1)
    a = jnp.take_along_axis(refbuf[:, None, :].repeat(n, 1).reshape(N, n, 3 * n + 2),
                            gi, axis=2)
    b = jnp.take_along_axis(refbuf[:, None, :].repeat(n, 1).reshape(N, n, 3 * n + 2),
                            jnp.clip(gi + 1, 0, 3 * n + 1), axis=2)
    angp = ((32 - fact) * a + fact * b + 16) >> 5            # (N,n,n)
    # horizontal modes: transpose result
    angp = jnp.where(is_vert[:, None, None], angp,
                     jnp.swapaxes(angp, 1, 2))
    # boundary filters for modes 26/10 (luma, n<32)
    if luma and n < 32:
        corner = ref[:, c]
        col26 = jnp.clip(ref[:, c + 1][:, None] + ((left - corner[:, None]) >> 1),
                         0, maxv)
        angp = jnp.where((modes == 26)[:, None, None],
                         angp.at[:, :, 0].set(col26), angp)
        row10 = jnp.clip(ref[:, c - 1][:, None] + ((top - corner[:, None]) >> 1),
                         0, maxv)
        angp = jnp.where((modes == 10)[:, None, None],
                         angp.at[:, 0, :].set(row10), angp)

    return jnp.where((modes == 0)[:, None, None], planar,
                     jnp.where((modes == 1)[:, None, None], dcp, angp))


@partial(jax.jit,
         static_argnames=("log2", "cidx", "bitdepth", "strong", "smooth"))
def predict_level(plane, by, bx, src, none_avail, modes, coeff_res, has_res,
                  xs, ys, valid, log2, cidx, bitdepth, strong, smooth=None):
    """One wavefront-level bucket: border gather + substitution + filtering +
    35-mode prediction + residual add + scatter. plane (H,W) int32;
    coeff_res (N,n,n) residual (already inverse-transformed).
    Returns updated plane."""
    n = 1 << log2
    maxv = (1 << bitdepth) - 1
    raw = plane[by, bx]                                     # (N, L)
    ref = jnp.take_along_axis(raw, src, axis=1)
    ref = jnp.where(none_avail[:, None], 1 << (bitdepth - 1), ref)
    if smooth is None:
        smooth = cidx == 0
    pred = predict_core(ref, modes, log2, cidx == 0, bitdepth, strong,
                        smooth)
    N = by.shape[0]
    out = jnp.clip(pred + jnp.where(has_res[:, None, None], coeff_res, 0),
                   0, maxv)
    # scatter back: delta-add into a slot table (TU positions are n-aligned
    # and unique within a level; padded rows add 0). Plane dims need not
    # be n-multiples (e.g. 1080 with 16/32 TUs): pad the lattice — real
    # TUs always fit inside the picture, so the pad region only ever
    # receives zero deltas.
    H, W = plane.shape
    Hp, Wp = -(-H // n) * n, -(-W // n) * n
    pl = plane if (Hp == H and Wp == W) else \
        jnp.pad(plane, ((0, Hp - H), (0, Wp - W)))
    rows = out.reshape(N, n * n)
    slots = (ys >> log2) * (Wp >> log2) + (xs >> log2)
    cur = pl.reshape(Hp >> log2, n, Wp >> log2, n).transpose(0, 2, 1, 3)         .reshape(-1, n * n)[slots]
    deltas = jnp.where(valid[:, None], rows - cur, 0)
    table = jnp.zeros(((Hp >> log2) * (Wp >> log2), n * n), jnp.int32)
    table = table.at[slots].add(deltas)
    delta = table.reshape(Hp >> log2, Wp >> log2, n, n).transpose(0, 2, 1, 3)         .reshape(Hp, Wp)
    return plane + delta[:H, :W]


def intra_reconstruct_device(plan, planes, bitdepth=8, strong=False):
    """Run all intra TUs of a frame as batched wavefront levels on device.
    planes: [Y,Cb,Cr] numpy arrays with inter prediction+residual and PCM
    already applied. Modifies planes in place."""
    from ..intra_wavefront import assign_levels
    from ..reconstruct import Availability
    from .transform_ref import scale_and_inv_transform
    from .transform_jax import residual_batch

    levels, n_levels = assign_levels(plan)
    avail = Availability(plan)
    # group intra TUs by (level, plane, log2)
    groups = {}
    for tu, lvl in zip(plan.tus, levels):
        if tu.cidx < 0 or tu.pred_mode != MODE_INTRA:
            continue
        groups.setdefault((lvl, tu.cidx, tu.log2), []).append(tu)
    dev_planes = [jnp.asarray(p, jnp.int32) for p in planes]
    strong = bool(plan.sps.strong_intra_smoothing_enable_flag)
    for lvl in range(1, n_levels + 1):
        for cidx in range(3):
            for log2 in (2, 3, 4, 5):
                tus = groups.get((lvl, cidx, log2))
                if not tus:
                    continue
                n = 1 << log2
                N = len(tus)
                Np = _pad(N)
                by, bx, src, na = host_border_info(plan, avail, tus, cidx,
                                                   log2, bitdepth)
                by = np.pad(by, ((0, Np - N), (0, 0)))
                bx = np.pad(bx, ((0, Np - N), (0, 0)))
                src = np.pad(src, ((0, Np - N), (0, 0)))
                na = np.pad(na, (0, Np - N))
                modes = np.array([tu.intra_mode for tu in tus], np.int32)
                modes = np.pad(modes, (0, Np - N), constant_values=1)
                xs = np.array([tu.x for tu in tus], np.int32)
                ys = np.array([tu.y for tu in tus], np.int32)
                xs = np.pad(xs, (0, Np - N))
                ys = np.pad(ys, (0, Np - N))
                valid = np.zeros(Np, bool)
                valid[:N] = True
                # residuals
                res = np.zeros((Np, n, n), np.int32)
                has = np.zeros(Np, bool)
                coeffs_std = []
                std_idx = []
                use_sl = bool(plan.sps.scaling_list_enable_flag)
                for i, tu in enumerate(tus):
                    if tu.coeffs is None:
                        continue
                    has[i] = True
                    if tu.tq_bypass or tu.transform_skip or use_sl:
                        smat = sdc = None
                        if use_sl and not tu.tq_bypass:
                            from ..reconstruct import _scaling_matrix
                            smat, sdc = _scaling_matrix(
                                plan.sps.scaling_list, log2, cidx, True)
                        res[i] = scale_and_inv_transform(
                            tu.coeffs, tu.qp, log2,
                            cidx == 0 and log2 == 2, tu.transform_skip,
                            tu.tq_bypass, bitdepth, smat, sdc)
                    else:
                        std_idx.append(i)
                        coeffs_std.append(tu.coeffs)
                if std_idx:
                    qps = np.array([tus[i].qp for i in std_idx], np.int32)
                    nstd = len(std_idx)
                    nstd_p = _pad(nstd)
                    carr = np.zeros((nstd_p, n, n), np.int32)
                    carr[:nstd] = np.stack(coeffs_std)
                    qarr = np.pad(qps, (0, nstd_p - nstd))
                    r = np.asarray(residual_batch(
                        jnp.asarray(carr), jnp.asarray(qarr), log2,
                        cidx == 0 and log2 == 2, bitdepth))
                    for k, i in enumerate(std_idx):
                        res[i] = r[k]
                smooth = (cidx == 0 or plan.sps.ChromaArrayType == 3) \
                    and not plan.sps.intra_smoothing_disabled_flag
                dev_planes[cidx] = predict_level(
                    dev_planes[cidx], jnp.asarray(by), jnp.asarray(bx),
                    jnp.asarray(src), jnp.asarray(na), jnp.asarray(modes),
                    jnp.asarray(res), jnp.asarray(has), jnp.asarray(xs),
                    jnp.asarray(ys), jnp.asarray(valid), log2, cidx,
                    bitdepth, strong, smooth)
    for ci in range(3):
        planes[ci][...] = np.asarray(dev_planes[ci]).astype(planes[ci].dtype)
