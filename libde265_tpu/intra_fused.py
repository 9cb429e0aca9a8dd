"""Fused-path intra reconstruction: wavefront levels inside the frame
program.

The reference decodes intra TUs inline in the serial CTB loop
(/root/reference/libde265/intrapred.cc:1074-1164, slice.cc:3424-3488).
The device path keeps whole frames device-resident: the host assigns every
intra TU a wavefront *level* (longest border-dependency chain,
intra_wavefront.py semantics) and ships, per (luma/chroma, log2) class,
a flat level-sorted TU array plus per-level offsets. On device a single
`lax.fori_loop` walks the levels; each step dynamic-slices a fixed-size
window of that level's TUs per class, gathers borders from the flattened
Y|Cb|Cr plane buffer, substitutes via the host-packed availability bits
(spec 8.4.4.2.2), predicts (ops/intra_jax.predict_core — shared with the
hybrid oracle path), adds the pre-computed residual and scatters back.
Residuals are level-independent, so ONE batched inverse transform per
class runs before the loop, leaving only the serial-by-nature
border chain inside it.

Host-side cost is vectorized numpy except the per-TU level DP (a strict
decode-order recurrence); the native front-end mirrors it in C++ when
available.
"""
import numpy as np

from .plan import MODE_INTRA

# class id: (pl, log2) with pl 0 = luma, 1 = chroma (Cb and Cr rows share
# a class — identical geometry/levels, plane chosen per row)
INTRA_LOG2S = (2, 3, 4, 5)


def _okbytes(log2):
    return (4 * (1 << log2) + 1 + 7) // 8


# --------------------------------------------------------------- host side
def _spread_bits(v):
    out = 0
    b = 0
    while v:
        out |= (v & 1) << (2 * b)
        v >>= 1
        b += 1
    return out


def _avail_grids(plan):
    """(zg, sa4, tid4) at 4x4-luma-block granularity. zg is the global
    decode order (tile-scan CTB order × z-order within the CTB), so
    `zg[nb] < zg[cur]` == the reference's ts/z-scan availability check
    (image.cc available_zscan)."""
    g = getattr(plan, "_avail_grids", None)
    if g is not None:
        return g
    sps, pps = plan.sps, plan.pps
    gh, gw = plan.gh, plan.gw
    s = sps.Log2CtbSizeY - 2
    by4, bx4 = np.mgrid[0:gh, 0:gw].astype(np.int32)
    cy, cx = by4 >> s, bx4 >> s
    rs = cy * sps.PicWidthInCtbsY + cx
    ts = np.asarray(pps.CtbAddrRStoTS, np.int32)[rs]
    spread = np.asarray([_spread_bits(v) for v in range(1 << s)], np.int32)
    m = (1 << s) - 1
    zin = spread[bx4 & m] | (spread[by4 & m] << 1)
    zg = (ts << (2 * s)) | zin
    sa4 = np.asarray(plan.slice_addr_rs, np.int32)[cy, cx]
    tid4 = np.asarray(pps.TileId, np.int32)[rs]
    plan._avail_grids = (zg, sa4, tid4)
    return plan._avail_grids


def assign_levels_meta(plan):
    """Per-tu_meta-row wavefront level (0 = not an intra TU). Exact
    longest-chain DP in decode order (intra_wavefront.assign_levels
    semantics, operating on the SoA tu_meta instead of TURecords)."""
    cached = getattr(plan, "_intra_levels", None)
    if cached is not None:
        return cached
    tm = plan._tu_arrays[0]
    N = tm.shape[0]
    levels = np.zeros(N, np.int32)
    if N:
        # PER-AXIS chroma scale (4:2:2 halves only horizontally)
        subw = plan.sps.SubWidthC if plan.sps.ChromaArrayType else 1
        subh = plan.sps.SubHeightC if plan.sps.ChromaArrayType else 1
        gh, gw = plan.gh, plan.gw
        L = [np.zeros((gh, gw), np.int32) for _ in range(3)]
        cidx_c = tm[:, 0]
        x_c = tm[:, 1]
        y_c = tm[:, 2]
        log2_c = tm[:, 3]
        pm_c = tm[:, 8]
        for i in range(N):
            cidx = cidx_c[i]
            if cidx < 0 or pm_c[i] != MODE_INTRA:
                continue
            scx = 1 if cidx == 0 else subw
            scy = 1 if cidx == 0 else subh
            n = 1 << log2_c[i]
            x0 = x_c[i] * scx
            y0 = y_c[i] * scy
            spanx, spany = n * scx, n * scy
            g = L[cidx]
            gx0, gy0 = x0 >> 2, y0 >> 2
            gsx = max(1, spanx >> 2)
            gsy = max(1, spany >> 2)
            dep = 0
            bx = (x0 - 1) >> 2
            if bx >= 0:
                y_end = min(gh - 1, (y0 + 2 * spany - 1) >> 2)
                col = g[gy0:y_end + 1, bx]
                if col.size:
                    dep = int(col.max())
            by = (y0 - 1) >> 2
            if by >= 0:
                x_end = min(gw - 1, (x0 + 2 * spanx - 1) >> 2)
                row = g[by, max(0, bx):x_end + 1]
                if row.size:
                    dep = max(dep, int(row.max()))
            lvl = dep + 1
            g[gy0:gy0 + gsy, gx0:gx0 + gsx] = lvl
            levels[i] = lvl
    plan._intra_levels = levels
    return levels


def _border_ok(plan, xs, ys, cidx_arr, log2):
    """Vectorized availability for a class batch: (N, 4n+1) bool mask of
    border-sample availability incl. constrained-intra-pred (spec 6.4.1 +
    8.4.4.2.2; reference intra_border_computer intrapred.cc:437-530).

    Availability is constant within each aligned run of border samples
    that shares one 4x4-luma-grid cell (4 luma / 2 chroma-in-4:2:0
    samples), so the decision is computed once per run and expanded —
    4x (2x) fewer gathers than per-sample."""
    N = xs.shape[0]
    is_luma = N > 0 and not (cidx_arr != 0).any()
    is_chroma = N > 0 and not (cidx_arr == 0).any()
    if N and (is_luma or is_chroma):
        subw = plan.sps.SubWidthC if plan.sps.ChromaArrayType else 1
        subh = plan.sps.SubHeightC if plan.sps.ChromaArrayType else 1
        scx = 1 if is_luma else subw
        scy = 1 if is_luma else subh
        if 4 // scx > 1 or 4 // scy > 1:
            return _border_ok_runs(plan, xs, ys, is_luma, subw, subh,
                                   scx, scy, log2)
    return _border_ok_dense(plan, xs, ys, cidx_arr, log2)


def _border_ok_runs(plan, xs, ys, is_luma, subw, subh, scx, scy, log2):
    """Run-granular availability (one decision per 4x4-grid-aligned run
    of border samples; run lengths are per-axis — 4:2:2 top runs are 2
    samples, left runs 4). Correct because the z-scan frontier, slice
    ids and tile ids are all constant within one 4x4-luma cell, and TU
    origins/plane dims are run-aligned."""
    zg, sa4, tid4 = _avail_grids(plan)
    gh, gw = zg.shape
    n = 1 << log2
    c = 2 * n
    gy, gx = 4 // scy, 4 // scx           # run lengths (left | top)
    nbl, nbt = c // gy, c // gx           # runs per segment
    x = xs.astype(np.int32)[:, None]
    y = ys.astype(np.int32)[:, None]
    N = x.shape[0]
    Hp = plan.H if is_luma else plan.H // subh
    Wp = plan.W if is_luma else plan.W // subw
    kl = np.arange(nbl, dtype=np.int32)[None, :]
    kt = np.arange(nbt, dtype=np.int32)[None, :]
    # run representatives: left runs in pos order (bottom-up), corner,
    # top runs left-to-right; left run k covers samples
    # by in [y + c - gy*(k+1), ...+gy) at bx = x-1
    by = np.concatenate([y + (c - gy * (kl + 1)),
                         y - 1,
                         np.broadcast_to(y - 1, (N, nbt))], axis=1)
    bx = np.concatenate([np.broadcast_to(x - 1, (N, nbl)),
                         x - 1,
                         x + gx * kt], axis=1)
    inb = (bx >= 0) & (by >= 0) & (bx < Wp) & (by < Hp)
    nby = np.clip((by * scy) >> 2, 0, gh - 1)
    nbx = np.clip((bx * scx) >> 2, 0, gw - 1)
    cby = (y * scy) >> 2
    cbx = (x * scx) >> 2
    okb = (inb & (zg[nby, nbx] < zg[cby, cbx])
           & (sa4[nby, nbx] == sa4[cby, cbx])
           & (tid4[nby, nbx] == tid4[cby, cbx]))
    if plan.pps.constrained_intra_pred_flag:
        okb &= plan.pred_mode[nby, nbx] == MODE_INTRA
    return np.concatenate([np.repeat(okb[:, :nbl], gy, axis=1),
                           okb[:, nbl:nbl + 1],
                           np.repeat(okb[:, nbl + 1:], gx, axis=1)],
                          axis=1)


def _border_ok_dense(plan, xs, ys, cidx_arr, log2):
    """Per-sample reference implementation (mixed-plane batches and the
    differential oracle for _border_ok_runs)."""
    zg, sa4, tid4 = _avail_grids(plan)
    gh, gw = zg.shape
    subw = plan.sps.SubWidthC if plan.sps.ChromaArrayType else 1
    subh = plan.sps.SubHeightC if plan.sps.ChromaArrayType else 1
    scx = np.where(cidx_arr == 0, 1, subw).astype(np.int64)[:, None]
    scy = np.where(cidx_arr == 0, 1, subh).astype(np.int64)[:, None]
    n = 1 << log2
    Lb = 4 * n + 1
    c = 2 * n
    pos = np.arange(Lb, dtype=np.int64)[None, :]
    x = xs.astype(np.int64)[:, None]
    y = ys.astype(np.int64)[:, None]
    by = np.where(pos < c, y + c - pos - 1, y - 1)
    bx = np.where(pos > c, x + pos - c - 1, x - 1)
    # plane bounds (own sample units; per-axis scale — 4:2:2 halves
    # only horizontally)
    Hp_l = np.where(cidx_arr == 0, plan.H, plan.H // subh)[:, None]
    Wp_l = np.where(cidx_arr == 0, plan.W, plan.W // subw)[:, None]
    inb = (bx >= 0) & (by >= 0) & (bx < Wp_l) & (by < Hp_l)
    nby = np.clip((by * scy) >> 2, 0, gh - 1)
    nbx = np.clip((bx * scx) >> 2, 0, gw - 1)
    cby = np.clip((y * scy) >> 2, 0, gh - 1)
    cbx = np.clip((x * scx) >> 2, 0, gw - 1)
    ok = (inb & (zg[nby, nbx] < zg[cby, cbx])
          & (sa4[nby, nbx] == sa4[cby, cbx])
          & (tid4[nby, nbx] == tid4[cby, cbx]))
    if plan.pps.constrained_intra_pred_flag:
        ok &= plan.pred_mode[nby, nbx] == MODE_INTRA
    return ok


def intra_frame_stats(plan):
    """Per-class level histogram for stream_cfg capacity derivation.
    Returns (n_levels, {(pl, log2): (max_per_level, total, n_escapes,
    kind_mask)}); kind_mask bit0 = transform-skip present, bit1 =
    tq-bypass present."""
    tm, coeff_pool, _ = plan._tu_arrays
    levels = assign_levels_meta(plan)
    out = {}
    n_levels = int(levels.max()) if levels.size else 0
    for log2 in INTRA_LOG2S:
        for pl in (0, 1):
            sel = ((levels > 0) & (tm[:, 3] == log2)
                   & ((tm[:, 0] == 0) if pl == 0 else (tm[:, 0] > 0)))
            k = int(sel.sum())
            if not k:
                continue
            lv = levels[sel]
            cnt = np.bincount(lv)
            ne = 0
            co = tm[sel, 9]
            has = co >= 0
            if has.any():
                nn = 1 << (2 * log2)
                gi = co[has][:, None] + np.arange(nn)[None, :]
                cgi = coeff_pool[gi]
                ne = int(((cgi < -8) | (cgi > 7)).sum())
            kinds = (1 if (tm[sel, 6] != 0).any() else 0) | \
                (2 if (tm[sel, 7] != 0).any() else 0)
            out[(pl, log2)] = (int(cnt.max()), k, ne, kinds)
    return n_levels, out


def pack_intra(plan, cfg):
    """Host: per-class flat level-sorted tensors for the device scan.
    Emits (into a dict) for each cfg.intra class (pl, log2, Ktot, Klvl, E):
      ixy_{pl}_{l}: (Ktot,2) int16 x,y (plane units)
      imd_{pl}_{l}: (Ktot,)  int8  mode
      iok_{pl}_{l}: (Ktot,OB) uint8 packed border-availability bits
      ipl_{pl}_{l}: (Ktot,)  int8  cidx (chroma classes only)
      icf_{pl}_{l}: (Ktot,n*n) int8 coeff body (+ iei/iev escapes when E)
      iqp_{pl}_{l}: (Ktot,)  int8  QP
      ioff_{pl}_{l}: (C+1,) int32 level offsets"""
    t = {}
    tm, coeff_pool, _ = plan._tu_arrays
    levels = assign_levels_meta(plan)
    C = cfg.intra_C
    for (pl, log2, Ktot, Klvl, E, kinds) in cfg.intra:
        n = 1 << log2
        nn = n * n
        OB = _okbytes(log2)
        sel = ((levels > 0) & (tm[:, 3] == log2)
               & ((tm[:, 0] == 0) if pl == 0 else (tm[:, 0] > 0)))
        idx = np.flatnonzero(sel)
        # availability in flatnonzero order, permuted below
        ok0 = _border_ok(plan, tm[idx, 1], tm[idx, 2], tm[idx, 0],
                         log2) if idx.size else None
        lv = levels[idx]
        order = np.argsort(lv, kind="stable")
        idx = idx[order]
        lv = lv[order]
        k = idx.size
        assert k + Klvl <= Ktot, (pl, log2, k, Klvl, Ktot)
        cnt = np.bincount(lv, minlength=C + 1)
        assert lv.size == 0 or (int(lv.max()) <= C
                                and int(cnt[1:].max()) <= Klvl), \
            (pl, log2, C, Klvl)
        off = np.zeros(C + 1, np.int32)
        off[1:] = np.cumsum(cnt[1:C + 1])
        xy = np.zeros((Ktot, 2), np.int16)
        xy[:k, 0] = tm[idx, 1]
        xy[:k, 1] = tm[idx, 2]
        md = np.ones(Ktot, np.int8)
        md[:k] = tm[idx, 4]
        okb = np.zeros((Ktot, OB), np.uint8)
        if k:
            okb[:k] = np.packbits(ok0[order], axis=1)
        qp = np.zeros(Ktot, np.int8)
        qp[:k] = tm[idx, 5]
        if kinds:
            kd = np.zeros(Ktot, np.int8)
            kd[:k] = np.where(tm[idx, 7] != 0, 2,
                              np.where(tm[idx, 6] != 0, 1, 0))
            t[f"ikd_{pl}_{log2}"] = kd
        cf = np.zeros((Ktot, nn), np.int16)
        co = tm[idx, 9]
        has = co >= 0
        if has.any():
            gi = co[has][:, None] + np.arange(nn)[None, :]
            cf[np.flatnonzero(has)] = coeff_pool[gi]
        # 4-bit nibble body + escapes, mirroring the inter residual
        # buckets (99.7% of levels fit [-8,7]; halves the I-frame's
        # dominant upload tensor)
        cnib = (cf & 15).astype(np.uint8)
        c8 = cnib[:, 0::2] | (cnib[:, 1::2] << 4)     # (Ktot, nn//2)
        sfx = f"_{pl}_{log2}"
        if E:
            flat = cf.reshape(-1)
            eidx = np.flatnonzero((flat < -8) | (flat > 7))
            assert eidx.size <= E, (pl, log2, eidx.size, E)
            ridx = np.full(E, Ktot * nn, np.int32)
            rval = np.zeros(E, np.int16)
            ridx[:eidx.size] = eidx
            rval[:eidx.size] = flat[eidx]
            t["iei" + sfx] = ridx
            t["iev" + sfx] = rval
        else:
            assert bool(((cf >= -8) & (cf <= 7)).all()), \
                "intra escape capacity 0 but levels outside [-8,7]"
        t["ixy" + sfx] = xy
        t["imd" + sfx] = md
        t["iok" + sfx] = okb
        t["iqp" + sfx] = qp
        t["icf" + sfx] = c8
        t["ioff" + sfx] = off
        if pl == 1:
            ip = np.ones(Ktot, np.int8)
            ip[:k] = tm[idx, 0]
            t["ipl" + sfx] = ip
    return t


# ------------------------------------------------------------- device side
def _residuals(t, cfg):
    """Batched per-class inverse transforms (level-independent, so ONE
    batched pass per class; transform.cc:352-625 capability incl. DST,
    transform-skip, tq-bypass, scaling lists)."""
    import jax.numpy as jnp
    from .ops.transform_jax import residual_batch

    bd = cfg.bitdepth
    res_all = {}
    for (pl, log2, Ktot, Klvl, E, kinds) in cfg.intra:
        n = 1 << log2
        nn = n * n
        sfx = f"_{pl}_{log2}"
        b = t["icf" + sfx].astype(jnp.int32)      # nibble pairs
        lo = ((b & 15) << 28) >> 28
        hi = ((b >> 4) << 28) >> 28
        c = jnp.stack([lo, hi], axis=-1).reshape(b.shape[0], -1)
        if E:
            fl = jnp.concatenate([c.reshape(Ktot * nn),
                                  jnp.zeros(1, jnp.int32)])
            fl = fl.at[t["iei" + sfx]].set(t["iev" + sfx].astype(jnp.int32))
            c = fl[:Ktot * nn]
        c = c.reshape(Ktot, n, n)
        qpv = t["iqp" + sfx].astype(jnp.int32)
        is_dst = pl == 0 and log2 == 2
        if cfg.scaling:
            from .ops.transform_jax import (residual_batch_sl,
                                            dequant_batch_sl)
            smat = t["ism" + sfx].astype(jnp.int32)
            if pl == 1:       # per-row Cb/Cr matrix select
                smat = smat[t["ipl" + sfx].astype(jnp.int32) - 1]
            res = residual_batch_sl(c, qpv, smat, log2, is_dst, bd)
        else:
            res = residual_batch(c, qpv, log2, is_dst, bd)
        if kinds:
            from .ops.transform_jax import (dequant_batch,
                                            transform_skip_batch)
            kd = t["ikd" + sfx].astype(jnp.int32)[:, None, None]
            if kinds & 1:
                d = dequant_batch_sl(c, qpv, smat, log2, bd) \
                    if cfg.scaling else dequant_batch(c, qpv, log2, bd)
                res = jnp.where(kd == 1,
                                transform_skip_batch(d, log2, bd), res)
            if kinds & 2:
                res = jnp.where(kd == 2, c, res)
        res_all[sfx] = res
    return res_all


def intra_stage(Y, Cb, Cr, t, cfg):
    """Device: reconstruct all intra TUs in-program. Planes arrive with
    inter prediction + inter residuals + PCM applied; returns updated
    (Y, Cb, Cr) int32: one lax.fori_loop over the wavefront levels."""
    import jax
    import jax.numpy as jnp
    from .ops.intra_jax import predict_core

    H, W = cfg.H, cfg.W
    Hc, Wc = cfg.chroma_dims
    bd = cfg.bitdepth
    maxv = (1 << bd) - 1
    res_all = _residuals(t, cfg)

    def class_step(flat, i, pl, log2, Ktot, Klvl, E):
        """One level window of one class against its OWN plane buffer
        (luma: (H*W+1,), chroma: (2*Hc*Wc+1,) [Cb|Cr]); keeping the
        buffers separate and the step unconditional lets XLA alias the
        fori carry in place instead of copying ~50 MB per step."""
        n = 1 << log2
        Lb = 4 * n + 1
        c2 = 2 * n
        OB = _okbytes(log2)
        sfx = f"_{pl}_{log2}"
        off = t["ioff" + sfx]
        start = off[i]
        end = off[i + 1]
        xy = jax.lax.dynamic_slice(t["ixy" + sfx], (start, 0),
                                   (Klvl, 2)).astype(jnp.int32)
        md = jax.lax.dynamic_slice_in_dim(t["imd" + sfx], start,
                                          Klvl).astype(jnp.int32)
        okb = jax.lax.dynamic_slice(t["iok" + sfx], (start, 0),
                                    (Klvl, OB))
        resw = jax.lax.dynamic_slice(res_all[sfx], (start, 0, 0),
                                     (Klvl, n, n))
        xw, yw = xy[:, 0], xy[:, 1]
        if pl == 0:
            base = jnp.zeros(Klvl, jnp.int32)
            Hp_, Wp_ = H, W
            dump = H * W
        else:
            sel = jax.lax.dynamic_slice_in_dim(
                t["ipl" + sfx], start, Klvl).astype(jnp.int32)
            base = (sel - 1) * (Hc * Wc)
            Hp_, Wp_ = Hc, Wc
            dump = 2 * Hc * Wc
        pos = jnp.arange(Lb, dtype=jnp.int32)[None, :]
        by = jnp.where(pos < c2, yw[:, None] + c2 - pos - 1,
                       yw[:, None] - 1)
        bx = jnp.where(pos > c2, xw[:, None] + pos - c2 - 1,
                       xw[:, None] - 1)
        gi = base[:, None] + jnp.clip(by, 0, Hp_ - 1) * Wp_ + \
            jnp.clip(bx, 0, Wp_ - 1)
        raw = flat[gi].astype(jnp.int32)                 # (Klvl, Lb)
        bits = (okb[:, :, None] >>
                (7 - jnp.arange(8, dtype=jnp.uint8))[None, None, :]) & 1
        okm = bits.reshape(Klvl, OB * 8)[:, :Lb] != 0
        idxv = jnp.where(okm, pos, -1)
        ffill = jax.lax.cummax(idxv, axis=1)
        anyok = okm.any(axis=1)
        first = jnp.argmax(okm, axis=1).astype(jnp.int32)
        src = jnp.where(ffill >= 0, ffill, first[:, None])
        ref = jnp.take_along_axis(raw, src, axis=1)
        ref = jnp.where(anyok[:, None], ref, 1 << (bd - 1))
        pred = predict_core(ref, md, log2, pl == 0, bd, cfg.strong,
                            smooth=pl == 0 or cfg.chroma_fmt == 3)
        out = jnp.clip(pred + resw, 0, maxv)
        valid = start + jnp.arange(Klvl, dtype=jnp.int32) < end
        rr = jnp.arange(n, dtype=jnp.int32)
        didx = (base[:, None, None]
                + (yw[:, None, None] + rr[None, :, None]) * Wp_
                + xw[:, None, None] + rr[None, None, :])
        didx = jnp.where(valid[:, None, None], didx, dump)
        # the border gather reads the SAME buffer the scatter writes;
        # without a barrier XLA refuses to alias the loop carry in place
        # and copies the whole plane every level (~0.7 ms/level at 4K).
        # The barrier pins the gather before the scatter, making the
        # in-place update safe.
        flat, out = jax.lax.optimization_barrier((flat, out))
        return flat.at[didx.reshape(-1)].set(
            out.reshape(-1).astype(flat.dtype), mode="drop",
            unique_indices=True)

    # narrow carry dtype: XLA copies these buffers every level (the
    # gather-from-carry defeats in-place scatter aliasing), so the copy
    # cost scales with carry BYTES — uint8/int16 quarters/halves it
    cdt = jnp.uint8 if bd <= 8 else jnp.int16
    yflat = jnp.concatenate([Y.reshape(-1), jnp.zeros(1, Y.dtype)]) \
        .astype(cdt)
    cflat = jnp.concatenate([Cb.reshape(-1), Cr.reshape(-1),
                             jnp.zeros(1, Cb.dtype)]).astype(cdt)

    def body(i, carry):
        yf, cf = carry
        for (pl, log2, Ktot, Klvl, E, kinds) in cfg.intra:
            if pl == 0:
                yf = class_step(yf, i, pl, log2, Ktot, Klvl, E)
            else:
                cf = class_step(cf, i, pl, log2, Ktot, Klvl, E)
        return yf, cf

    yflat, cflat = jax.lax.fori_loop(0, cfg.intra_C, body, (yflat, cflat))
    Y = yflat[:H * W].reshape(H, W).astype(jnp.int32)
    Cb = cflat[:Hc * Wc].reshape(Hc, Wc).astype(jnp.int32)
    Cr = cflat[Hc * Wc:2 * Hc * Wc].reshape(Hc, Wc).astype(jnp.int32)
    return Y, Cb, Cr
