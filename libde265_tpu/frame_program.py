"""The fused device-resident frame program.

One compiled XLA program decodes an entire inter frame on-chip from plan
tensors: tile-table MC -> residual batches -> deblock (metadata derived on
device) -> SAO -> DPB-stack insert. The DPB lives in HBM across frames
(donated carry); the host uploads only compact per-frame tensors and never
reads pixels back mid-stream. This is the device answer to the reference's
per-CTB threaded decode loop (decctx.cc:700-789, slice.cc:4664-4830): the
frame's whole dataflow graph is static, so XLA replaces the progress-lock
protocol entirely.

The fused path covers intra (wavefront levels), PCM (all chroma
formats, round 5), transform-skip, tq-bypass, scaling lists, 8/10/12-bit
and every chroma format. Frames that exercise a range-extension residual
tool (cross-component prediction, RDPCM, transform-skip rotation,
disabled intra smoothing, TU-level chroma QP offsets) fall back per
FRAME — see frame_compatible / frame_uses_rext_tools — to the hybrid or
reference recon with their pixels inserted into the device DPB stack, so
mixed streams stay bit-exact end to end (tests/test_frame_program.py,
tests/test_rext_tools.py vs golden MD5).
"""
from dataclasses import dataclass

import numpy as np
import jax

from .plan import MODE_INTRA, MODE_INTER

REF_SLOTS = 8          # device DPB stack depth (static program shape)


# --------------------------------------------------------------------- cfg
@dataclass(frozen=True)
class ProgramCfg:
    H: int
    W: int
    bitdepth: int
    log2ctb: int
    chroma_fmt: int
    cb_qpoff: int
    cr_qpoff: int
    pcm_lfd: bool
    sao_enabled: bool
    has_weights: bool
    n_slice_rows: int                 # S+1 (incl. sentinel)
    buckets: tuple                    # ((cidx, log2, K), ...)
    escapes: tuple = ()               # per-bucket escape capacity E: coeffs
                                      # upload as int8 + (idx,val) escape
                                      # lists for |v|>127 (cuts the upload
                                      # bytes ~2x; link is the e2e limit)
    r_act: int = REF_SLOTS            # MC tile tables built for this many
                                      # referenced slots (pow2 bucket)
    has_bi: bool = True               # any bi-predicted PU in the stream?
                                      # False skips the whole lane-1 MC path
    pu_grid8: bool = False            # every inter PU is >=8x8 and
                                      # 8-aligned: motion grids upload at
                                      # 8x8 granularity (4x fewer bytes)
                                      # and expand on device
    mc_caps: tuple = ()               # (h ids, v ids): populated class
                                      # sets for the class-masked matmul
                                      # luma MC (mc_mxu_jax);
                                      # () = elementwise tap path
    mc_caps_c: tuple = ()             # chroma (h ids, v ids) for the
                                      # paired Cb|Cr matmul pipeline
    pack_bits: bool = True            # 0/1 4x4 grids upload bit-packed
                                      # (8x fewer bytes on the dominant
                                      # per-frame tensors); device unpacks
                                      # with shifts
    qp_grid8: bool = False            # qp constant within 8x8: upload the
                                      # subsampled grid (4x fewer bytes)
    lane0: bool = False               # single-list stream: motion grids
                                      # upload as one pre-swapped lane
    sb_caps: tuple = ()               # per-bucket coded-sub-block upload
                                      # capacity (0 = dense (K,n,n)):
                                      # sparse streams ship only coded
                                      # 4x4 sub-blocks + indices, the
                                      # device row-scatters them back
    mv8: bool = False                 # all |mv| <= 127: ship int8 MVs
    poc8: bool = False                # all |poc delta| <= 127: int8
    scaling: bool = False             # sps/pps scaling lists: per-frame
                                      # (n,n) scale matrices upload per
                                      # bucket/class; dequant switches to
                                      # the m[x][y] path (8.6.3,
                                      # transform.cc:477-510)
    pcm: tuple = ()                   # PCM paste buckets ((log2, Kp), ...):
                                      # raw samples scatter into the frame
                                      # before the intra scan (the pm grid
                                      # masks MC out of PCM regions, so the
                                      # paste lands on zeros; read_pcm_
                                      # samples slice.cc:4144-4215)
    res_kinds: tuple = ()             # per-bucket residual-kind bitmask:
                                      # 1 = transform-skip present, 2 =
                                      # tq-bypass present (0 = pure IDCT;
                                      # nonzero ships a per-TU kind byte
                                      # and selects the variant on device)
    intra: tuple = ()                 # fused-path intra classes:
                                      # ((pl, log2, Ktot, Klvl, E), ...)
                                      # pl 0=luma 1=chroma (intra_fused.py);
                                      # () = intra TUs not supported
    intra_C: int = 0                  # wavefront level cap (fori trip)
    strong: bool = False              # sps strong_intra_smoothing
    skip_mc: bool = False             # zero-PU frames (I-frames): drop the
                                      # whole MC stage + motion uploads;
                                      # filter planners see zero grids

    @property
    def fcfg(self):
        return (self.log2ctb, self.pcm_lfd, self.chroma_fmt, self.bitdepth,
                self.bitdepth, self.cb_qpoff, self.cr_qpoff, self.H, self.W)

    @property
    def subw(self):
        return 2 if self.chroma_fmt in (1, 2) else 1

    @property
    def subh(self):
        return 2 if self.chroma_fmt == 1 else 1

    @property
    def mono(self):
        return self.chroma_fmt == 0

    @property
    def chroma_dims(self):
        """(Hc, Wc) of the chroma DPB stacks per format (mono keeps
        1x128 dummies so program shapes stay static)."""
        return {0: (1, 128), 1: (self.H // 2, self.W // 2),
                2: (self.H, self.W // 2),
                3: (self.H, self.W)}[self.chroma_fmt]

    @property
    def scfg(self):
        return (self.log2ctb, self.chroma_fmt, self.H, self.W,
                self.subw, self.subh)


def _ceil_pow2(n):
    p = 16
    while p < n:
        p <<= 1
    return p


def _ceil_sched(n):
    """Round a bucket capacity up at 1/8-power-of-two granularity: caps
    the number of distinct compiled shapes while wasting <=12.5% upload
    (the dense coeff buckets dominate the per-frame host->device bytes)."""
    if n <= 64:
        return 64
    step = 1 << max(3, n.bit_length() - 3)
    return -(-n // step) * step


# ------------------------------------------------------- host plan packing
def frame_compatible(plan):
    """Can this frame run through the fused device program? (Intra TUs
    fused since round 3 — intra_fused.py; 4:2:2/4:4:4/monochrome since
    round 4 — dense-gather chroma MC + per-axis filter geometry.)

    Range-extension residual tools (round 5: decoded by BOTH front-ends,
    reconstructed by the hybrid path) gate per actual USE in the frame —
    a rext-profile stream that never exercises a tool still runs fused;
    only the frames that use CCP / RDPCM / rotation / TU-level chroma QP
    offsets fall back to the hybrid device path (slice.cc:2937-2951,
    3530-3558, transform.cc:235-429)."""
    tu_meta = plan._tu_arrays[0] if plan._tu_arrays is not None else None
    if tu_meta is None:
        return False              # python front-end path: use hybrid
    if not len(plan.slice_headers):
        return False
    sps = plan.sps
    if tu_meta.shape[0]:
        if (tu_meta[:, 10] != 0).any():
            return False          # cross-component prediction used
        if (tu_meta[:, 11] > 0).any():
            return False          # explicit RDPCM used
        skipbyp = (tu_meta[:, 6] != 0) | (tu_meta[:, 7] != 0)
        intra = tu_meta[:, 8] == MODE_INTRA
        if getattr(sps, "implicit_rdpcm_enabled_flag", 0) and \
                (skipbyp & intra & ((tu_meta[:, 4] == 10)
                                    | (tu_meta[:, 4] == 26))).any():
            return False          # implicit RDPCM applies
        if getattr(sps, "transform_skip_rotation_enabled_flag", 0) and \
                (skipbyp & intra & (tu_meta[:, 3] == 2)).any():
            return False          # 4x4 transform-skip rotation applies
        if getattr(sps, "intra_smoothing_disabled_flag", 0) and \
                intra.any():
            return False          # fused border smoothing is mode-driven
    if getattr(plan.pps, "chroma_qp_offset_list_enabled_flag", 0):
        return False              # TU-level chroma QP offsets vary tu.qp
    return True


def frame_uses_rext_tools(plan):
    """Does the frame exercise a rext residual tool the batched hybrid
    recon does not implement? Such frames decode via the reference
    recon (reconstruct.py, which implements all five tools) and insert
    into the device DPB. Explicit RDPCM and TU-level chroma QP offsets
    are NOT in this set — the hybrid path handles them (per-TU qp, and
    the host ts/bypass residual branch applies the DPCM cumsum)."""
    sps = plan.sps
    irdpcm = getattr(sps, "implicit_rdpcm_enabled_flag", 0)
    rot = getattr(sps, "transform_skip_rotation_enabled_flag", 0)
    nosm = getattr(sps, "intra_smoothing_disabled_flag", 0)
    ccp = getattr(plan.pps, "cross_component_prediction_enabled_flag", 0)
    if not (irdpcm or rot or nosm or ccp):
        return False
    tu_meta = plan._tu_arrays[0] if plan._tu_arrays is not None else None
    if tu_meta is not None:
        if not tu_meta.shape[0]:
            return False
        if ccp and (tu_meta[:, 10] != 0).any():
            return True
        skipbyp = (tu_meta[:, 6] != 0) | (tu_meta[:, 7] != 0)
        intra = tu_meta[:, 8] == MODE_INTRA
        if irdpcm and (skipbyp & intra & ((tu_meta[:, 4] == 10)
                                          | (tu_meta[:, 4] == 26))).any():
            return True
        if rot and (skipbyp & intra & (tu_meta[:, 3] == 2)).any():
            return True
        return bool(nosm and intra.any())
    for tu in plan.tus:
        if tu.cidx < 0:
            continue
        if ccp and getattr(tu, "cross_comp_alpha", 0):
            return True
        if tu.pred_mode == MODE_INTRA:
            sb = tu.tq_bypass or tu.transform_skip
            if sb and irdpcm and tu.intra_mode in (10, 26):
                return True
            if sb and rot and tu.log2 == 2:
                return True
            if nosm:
                return True
    return False


def frame_has_intra(plan):
    tu_meta = plan._tu_arrays[0] if plan._tu_arrays is not None else None
    if tu_meta is None or not tu_meta.shape[0]:
        return False
    return bool((tu_meta[:, 8] == MODE_INTRA).any())


def frame_has_mc(plan):
    pu = plan._pu_arrays[0] if plan._pu_arrays is not None else None
    return pu is not None and bool(pu.shape[0])


def stream_cfg(plans, sps):
    """Static ProgramCfg covering every compatible frame of the stream."""
    kmax = {}
    smax = 1
    has_w = False
    has_bi = False
    grid8 = True
    r_act = 1
    qp8 = True
    imax = {}                     # (pl, log2) -> [Klvl, Ktot, E] intra caps
    intra_C = 0
    pcm_max = {}                  # log2 -> max PCM block count
    for plan in plans:
        if plan.nal_type == -1 or not frame_compatible(plan):
            continue
        pu_meta = plan._pu_arrays[0]
        if pu_meta.shape[0]:
            has_bi = has_bi or bool(
                ((pu_meta[:, 4] > 0) & (pu_meta[:, 5] > 0)).any())
            if not ((pu_meta[:, 2] >= 8) & (pu_meta[:, 3] >= 8) &
                    (pu_meta[:, 0] % 8 == 0) &
                    (pu_meta[:, 1] % 8 == 0)).all():
                grid8 = False
        fids = set()
        for l in range(2):
            if pu_meta.shape[0]:
                fids |= set(np.unique(
                    pu_meta[pu_meta[:, 4 + l] > 0, 14 + l]).tolist())
        while r_act < max(1, len(fids)):
            r_act <<= 1
        tu_meta = plan._tu_arrays[0]
        coeff_pool = plan._tu_arrays[1]
        if tu_meta.shape[0]:
            sel = (tu_meta[:, 9] >= 0) & (tu_meta[:, 8] == MODE_INTER)
            for cidx in range(3):
                m = sel & (tu_meta[:, 0] == cidx)
                for log2 in (2, 3, 4, 5):
                    mm = m & (tu_meta[:, 3] == log2)
                    k = int(mm.sum())
                    if k:
                        key = (cidx, log2)
                        kmax.setdefault(key, [0, 0, 0, 0])
                        kmax[key][0] = max(kmax[key][0], k)
                        n2 = 1 << (2 * log2)
                        gi = tu_meta[mm, 9][:, None] + np.arange(n2)[None, :]
                        cc = coeff_pool[gi]
                        # nibble body: escapes are levels outside the
                        # 4-bit two's-complement range [-8, 7]
                        ne = int(((cc < -8) | (cc > 7)).sum())
                        kmax[key][1] = max(kmax[key][1], ne)
                        n_ = 1 << log2
                        sb = cc.reshape(k, n_ // 4, 4, n_ // 4, 4)
                        nz = int((sb != 0).any(axis=(2, 4)).sum())
                        kmax[key][2] = max(kmax[key][2], nz)
                        # residual-kind bitmask: 1 = any transform-skip,
                        # 2 = any transquant-bypass (transform.cc:352-625)
                        if (tu_meta[mm, 6] != 0).any():
                            kmax[key][3] |= 1
                        if (tu_meta[mm, 7] != 0).any():
                            kmax[key][3] |= 2
        if tu_meta.shape[0]:
            pm_rows = tu_meta[:, 0] == -1
            if pm_rows.any():
                for log2 in (3, 4, 5):
                    kp = int((pm_rows & (tu_meta[:, 3] == log2)).sum())
                    if kp:
                        pcm_max[log2] = max(pcm_max.get(log2, 0), kp)
        smax = max(smax, len(plan.slice_headers))
        has_w = has_w or any(s.pred_weight is not None
                             for s in plan.slice_headers)
        if qp8:
            q = np.asarray(plan.qp_y)
            qs = np.repeat(np.repeat(q[::2, ::2], 2, 0), 2, 1)
            qp8 = bool(np.array_equal(qs[:q.shape[0], :q.shape[1]], q))
        if frame_has_intra(plan):
            from .intra_fused import intra_frame_stats
            nlv, st = intra_frame_stats(plan)
            intra_C = max(intra_C, nlv)
            for key, (mlvl, tot, ne, kinds) in st.items():
                e = imax.setdefault(key, [0, 0, 0, 0])
                e[0] = max(e[0], mlvl)
                e[1] = max(e[1], tot)
                e[2] = max(e[2], ne)
                e[3] |= kinds
    # class-masked matmul MC capacities: per-(h,v)-class max counts over
    # every compatible frame and every lane the program will run, using
    # the SAME numpy geometry the device traces (mc_mxu_jax.luma_geom)
    from .ops.mc_mxu_jax import (NCLS, NCLS_C, caps_from_counts,
                                 luma_class_counts, chroma_class_counts)
    H_, W_ = sps.pic_height_in_luma_samples, sps.pic_width_in_luma_samples
    hmax = np.zeros(NCLS, np.int64)
    vmax = np.zeros(NCLS, np.int64)
    hmax_c = np.zeros(NCLS_C, np.int64)
    vmax_c = np.zeros(NCLS_C, np.int64)
    any_mc = False
    mvmax = 0
    pocmax = 0
    for plan in plans:
        if plan.nal_type == -1 or not frame_compatible(plan) \
                or not frame_has_mc(plan):
            continue              # zero-PU frames run the skip_mc variant
        any_mc = True
        mvmax = max(mvmax, int(np.abs(np.asarray(plan.mv)).max()))
        pocmax = max(pocmax, int(np.abs(
            np.asarray(plan.ref_poc, np.int64) - plan.poc).max()))
        mv = np.asarray(plan.mv, np.int64)          # (gh,gw,2,2)
        pf = np.asarray(plan.pred_flag)
        N = mv.shape[0] * mv.shape[1]
        swap = (pf[:, :, 0] == 0)[..., None]
        lanes = [np.where(swap, mv[:, :, 1, :], mv[:, :, 0, :])
                 .reshape(N, 2)]
        if has_bi:
            lanes.append(mv[:, :, 1, :].reshape(N, 2))
        for lane_mv in lanes:
            hc, vc = luma_class_counts(lane_mv, H_, W_)
            hmax = np.maximum(hmax, hc)
            vmax = np.maximum(vmax, vc)
            if sps.ChromaArrayType == 1:
                hcc, vcc = chroma_class_counts(lane_mv, H_, W_)
                hmax_c = np.maximum(hmax_c, hcc)
                vmax_c = np.maximum(vmax_c, vcc)
    mc_caps = caps_from_counts(hmax, vmax) if any_mc else ()
    # chroma matmul MC classes exist only for the 4:2:0 tile-table path;
    # 4:2:2/4:4:4 chroma runs the dense in-program epel, mono has none
    mc_caps_c = caps_from_counts(hmax_c, vmax_c) \
        if any_mc and sps.ChromaArrayType == 1 else ()

    pps = plans[0].pps if plans else None
    order = sorted(kmax.items())
    return ProgramCfg(
        H=sps.pic_height_in_luma_samples, W=sps.pic_width_in_luma_samples,
        bitdepth=sps.BitDepthY, log2ctb=sps.Log2CtbSizeY,
        chroma_fmt=sps.ChromaArrayType,
        cb_qpoff=pps.pic_cb_qp_offset if pps else 0,
        cr_qpoff=pps.pic_cr_qp_offset if pps else 0,
        pcm_lfd=bool(sps.pcm_loop_filter_disable_flag),
        sao_enabled=bool(sps.sample_adaptive_offset_enabled_flag),
        has_weights=has_w,
        n_slice_rows=_ceil_pow2(smax + 1),
        buckets=tuple((c, l, _ceil_sched(ke[0])) for (c, l), ke in order),
        escapes=tuple(_ceil_sched(ke[1]) if ke[1] else 0
                      for (c, l), ke in order),
        res_kinds=tuple(ke[3] for (c, l), ke in order),
        pcm=tuple((l, _ceil_sched(k)) for l, k in sorted(pcm_max.items())),
        scaling=bool(sps.scaling_list_enable_flag),
        # sub-block upload only when it saves >=30% vs the dense body
        # (12 B/sub-block: 16 nibble values + int32 index, vs nn/2
        # dense nibble bytes per TU)
        sb_caps=tuple(
            _ceil_sched(ke[2])
            if ke[2] and _ceil_sched(ke[2]) * 12 <
            0.7 * _ceil_sched(ke[0]) * (1 << (2 * l - 1)) else 0
            for (c, l), ke in order),
        r_act=min(r_act, REF_SLOTS), has_bi=has_bi, pu_grid8=grid8,
        mc_caps=mc_caps, mc_caps_c=mc_caps_c, qp_grid8=qp8 and any_mc,
        lane0=not has_bi and not has_w and any_mc,
        mv8=any_mc and mvmax <= 127, poc8=any_mc and pocmax <= 127,
        # fused intra: Ktot pads the flat arrays with a full Klvl window
        # of headroom so every per-level dynamic_slice stays in bounds
        intra=tuple(
            (pl, l, _ceil_sched(e[1] + _ceil_sched(e[0])),
             _ceil_sched(e[0]), _ceil_sched(e[2]) if e[2] else 0, e[3])
            for (pl, l), e in sorted(imax.items())),
        intra_C=intra_C,
        strong=bool(sps.strong_intra_smoothing_enable_flag))


def table_geom(cfg: ProgramCfg):
    """Static geometry/dtype of the persistent MC tile tables: one table
    row per stride-4 tile of the edge-padded plane, REF_SLOTS slots deep
    (see ops/mc_tile_jax.py). Returns ((rows_y, 256), (rows_c, 64), dtype)
    for ONE slot; the carried tables have REF_SLOTS x rows. Chroma tile
    tables exist only for 4:2:0 (other formats read the chroma DPB
    stacks directly via the dense epel; mono has none)."""
    import jax.numpy as jnp
    from .ops.mc_tile_jax import n_tiles_y, n_tiles_c
    nty, ntx = n_tiles_y(cfg.H, cfg.W)
    dt = jnp.uint8 if cfg.bitdepth <= 8 else jnp.int16
    if cfg.chroma_fmt != 1:
        return (nty * ntx, 256), (1, 128), dt
    ntyc, ntxc = n_tiles_c(cfg.H // 2, cfg.W // 2)
    return (nty * ntx, 256), (ntyc * ntxc, 128), dt


def init_tables(cfg: ProgramCfg):
    """Zero-initialised persistent tile-table stacks (device)."""
    import jax.numpy as jnp
    (ry, wy), (rc, wc), dt = table_geom(cfg)
    return (jnp.zeros((REF_SLOTS * ry, wy), dt),
            jnp.zeros((REF_SLOTS * rc, wc), dt))


def update_tables(ty, tc, Y, Cb, Cr, slot, cfg: ProgramCfg):
    """Insert one frame's tile rows into the persistent tables at `slot`
    (device; Y/Cb/Cr int planes). Built once per decoded frame instead of
    per referencing frame — the reference rebuilds nothing (it reads pixel
    planes directly, motion.cc:69-98); our tile layout trades this one-time
    build for contiguous-row MC gathers. The tables are donated, so XLA
    writes the slot in place."""
    from .ops.mc_tile_jax import build_tables, build_tile_table_y, PAD_Y
    (ry, _), (rc, _), _ = table_geom(cfg)
    if cfg.chroma_fmt != 1:
        # luma-only tile build; chroma (if any) is read straight from
        # the DPB stacks by the dense epel in decode_frame_device
        import jax.numpy as jnp
        py = jnp.pad(Y.astype(jnp.int16),
                     ((PAD_Y, PAD_Y), (PAD_Y, PAD_Y)), mode="edge")
        ny = build_tile_table_y(py[None], out_dtype=ty.dtype)
        return jax.lax.dynamic_update_slice(ty, ny, (slot * ry, 0)), tc
    ny, nc = build_tables(Y[None], Cb[None], Cr[None],
                          bitdepth=cfg.bitdepth)
    ty = jax.lax.dynamic_update_slice(ty, ny, (slot * ry, 0))
    tc = jax.lax.dynamic_update_slice(tc, nc, (slot * rc, 0))
    return ty, tc


def filter_grids(plan, cfg: ProgramCfg):
    """Host: the loop-filter grids of one frame (device_plan
    .build_filter_grids), slice tables padded to cfg.n_slice_rows."""
    from .device_plan import build_filter_grids
    t = build_filter_grids(plan)
    S1 = cfg.n_slice_rows
    for k in ("sh_disable", "sh_beta", "sh_tc", "sh_across", "sh_sao_luma",
              "sh_sao_chroma"):
        a = t[k]
        t[k] = np.pad(a, (0, S1 - len(a)),
                      constant_values=(1 if k == "sh_disable" else 0))
    t["sidx"] = np.minimum(t["sidx"], S1 - 1)
    return t


def pack_frame(plan, cfg: ProgramCfg, fid_slot, real_slots=False):
    """Host: FramePlan -> dict of np arrays for the fused program.
    fid_slot: dict frame_id -> device stack slot.
    real_slots: emit actual DPB stack slots in t["slot"] (persistent-table
    fast path) instead of compact table ids + "sel_slots" (tile_shard's
    per-frame-build path)."""
    t = filter_grids(plan, cfg)
    S1 = cfg.n_slice_rows

    if cfg.intra:
        from .intra_fused import pack_intra
        t.update(pack_intra(plan, cfg))
    if cfg.skip_mc:
        # zero-PU frame program: no motion uploads at all (the deblock
        # planner gets zero grids on device)
        for k in ("mv", "poc", "pf"):
            del t[k]
    else:
        _pack_motion(t, plan, cfg, fid_slot, real_slots, S1)
    _pack_residual_buckets(t, plan, cfg, real_slots)
    if cfg.pcm:
        _pack_pcm(t, plan, cfg)
    if cfg.scaling:
        # per-frame scale matrices (DC substituted on host): one (n,n)
        # per inter bucket; (n,n) luma / (2,n,n) cb|cr per intra class
        from .reconstruct import _scaling_matrix
        sl = plan.pps.scaling_list \
            if plan.pps.pic_scaling_list_data_present_flag \
            else plan.sps.scaling_list

        def mat(log2, cidx, is_intra):
            m, dc = _scaling_matrix(sl, log2, cidx, is_intra)
            m = m.astype(np.int16)
            if dc is not None:
                m = m.copy()
                m[0, 0] = dc
            return m
        for (cidx, log2, K) in cfg.buckets:
            t[f"sm_{cidx}_{log2}"] = mat(log2, cidx, False)
        for ic in cfg.intra:
            pl, log2 = ic[0], ic[1]
            if pl == 0:
                t[f"ism_{pl}_{log2}"] = mat(log2, 0, True)
            else:
                t[f"ism_{pl}_{log2}"] = np.stack(
                    [mat(log2, 1, True), mat(log2, 2, True)])
    if real_slots and cfg.pack_bits:
        # 0/1 4x4-granular grids ship bit-packed (row-major bits,
        # numpy 'big' bit order); 2-bit edge masks (bit0 left, bit1 top)
        # ship as two stacked bit-planes; decode_frame_device unpacks
        for k in BIT_KEYS:
            t[k] = np.packbits(t[k].astype(bool), axis=1)
        for k in BIT2_KEYS:
            a = t[k]
            t[k] = np.packbits(
                np.stack([a & 1, (a >> 1) & 1]).astype(bool), axis=2)
        if cfg.qp_grid8:
            t["qp"] = np.ascontiguousarray(t["qp"][::2, ::2])
    if real_slots and cfg.lane0 and not cfg.skip_mc:
        # single-list stream: collapse the motion grids to ONE lane on
        # host (the swap the device would do anyway), halving the
        # dominant remaining upload tensors; the device re-widens with
        # a duplicate lane1 + pf1=0, which is semantics-neutral (the
        # deblock bS planner's single-vector path selects by pf and
        # every block has at most one vector)
        sw = t["pf"][:, :, 0] == 0
        t["mv"] = np.where(sw[:, :, None], t["mv"][:, :, 1, :],
                           t["mv"][:, :, 0, :])
        for k in ("poc", "slot"):
            t[k] = np.where(sw, t[k][:, :, 1], t[k][:, :, 0])
        t["pf"] = (t["pf"][:, :, 0] | t["pf"][:, :, 1])
    if real_slots and not cfg.skip_mc:
        # adaptive narrow dtypes (every consumer casts to int32 anyway)
        if cfg.mv8:
            t["mv"] = t["mv"].astype(np.int8)
        if cfg.poc8:
            t["poc"] = t["poc"].astype(np.int8)
    return t


def _pack_motion(t, plan, cfg, fid_slot, real_slots, S1):
    # ref-list tables (slice, list, idx) -> COMPACT ref slot / poc, from
    # pu_meta; sel_slots maps compact ids to DPB stack slots so the
    # program builds MC tables only for referenced frames.
    rl_slot = np.zeros((S1, 2, 16), np.int32)
    pu_meta = plan._pu_arrays[0] if plan._pu_arrays is not None else \
        np.zeros((0, 17), np.int32)
    used_fids = []
    compact = {}
    for l in range(2):
        pf = pu_meta[:, 4 + l] > 0
        if not pf.any():
            continue
        sh = pu_meta[pf, 16]
        ridx = pu_meta[pf, 10 + l]
        poc = pu_meta[pf, 12 + l]
        fid = pu_meta[pf, 14 + l]
        key = sh * 16 + ridx
        _, first = np.unique(key, return_index=True)
        for i in first:
            f = int(fid[i])
            if f not in compact:
                compact[f] = len(used_fids)
                used_fids.append(f)
            rl_slot[sh[i], l, ridx[i]] = compact[f]
    assert len(used_fids) <= cfg.r_act, (len(used_fids), cfg.r_act)
    sel = np.zeros(cfg.r_act, np.int32)
    for f, ci in compact.items():
        sel[ci] = fid_slot[f]
    if real_slots:
        # rewrite compact ids -> actual DPB slots in the rl table
        rl_slot = sel[np.clip(rl_slot, 0, cfg.r_act - 1)].astype(np.int32)
    else:
        t["sel_slots"] = sel
    # per-block compact ref slot, resolved on HOST (a 3-index device
    # gather over (gh,gw,2) on device; numpy does it for free)
    ridx_h = np.clip(plan.ref_idx, 0, 15).astype(np.int64)
    gh, gw = ridx_h.shape[:2]
    f = 1 << (cfg.log2ctb - 2)
    s4h = np.repeat(np.repeat(t["sidx"], f, 0), f, 1)[:gh, :gw]
    t["slot"] = rl_slot[s4h[:, :, None], np.arange(2)[None, None, :],
                        ridx_h].astype(np.int8)
    if cfg.has_weights:
        t["rl_slot"] = rl_slot
        t["ref_idx"] = ridx_h.astype(np.int8)
    if cfg.pu_grid8:
        # motion fields are constant within 8x8: upload the subsampled
        # grids, device expands (the 4 grids are ~30% of the upload)
        for k in (("mv", "poc", "pf", "slot", "ref_idx")
                  if cfg.has_weights else ("mv", "poc", "pf", "slot")):
            t[k] = np.ascontiguousarray(t[k][::2, ::2])

    # weights
    if cfg.has_weights:
        wt = np.zeros((S1, 2, 16, 3, 2), np.int32)
        denom = np.zeros((S1, 3), np.int32)
        has_pw = np.zeros(S1, np.int32)
        for si, s in enumerate(plan.slice_headers):
            pw = s.pred_weight
            if pw is None:
                continue
            has_pw[si] = 1
            denom[si, 0] = pw.luma_log2_weight_denom + 14 - cfg.bitdepth
            denom[si, 1] = denom[si, 2] = \
                pw.chroma_log2_weight_denom + 14 - cfg.bitdepth
            for l in range(2):
                nr = len(pw.luma_weight[l])
                for r in range(min(nr, 16)):
                    wt[si, l, r, 0] = (pw.luma_weight[l][r],
                                       pw.luma_offset[l][r])
                    wt[si, l, r, 1] = (pw.chroma_weight[l][r][0],
                                       pw.chroma_offset[l][r][0])
                    wt[si, l, r, 2] = (pw.chroma_weight[l][r][1],
                                       pw.chroma_offset[l][r][1])
        t["wt"] = wt
        t["wt_denom"] = denom
        t["has_pw"] = has_pw


def _pack_residual_buckets(t, plan, cfg, real_slots):
    # TU residual buckets (inter; intra residuals ship via pack_intra)
    tu_meta, coeff_pool, _ = plan._tu_arrays
    sel = (tu_meta[:, 9] >= 0) & (tu_meta[:, 8] == MODE_INTER) \
        if tu_meta.shape[0] else np.zeros(0, bool)
    for bi_, (cidx, log2, K) in enumerate(cfg.buckets):
        n = 1 << log2
        E = cfg.escapes[bi_] if cfg.escapes else 0
        if tu_meta.shape[0]:
            m = sel & (tu_meta[:, 0] == cidx) & (tu_meta[:, 3] == log2)
            rows = tu_meta[m]
        else:
            rows = np.zeros((0, 10), np.int32)
        k = rows.shape[0]
        assert k <= K, (cidx, log2, k, K)
        # work on the k REAL rows only (K is the padded stream max);
        # 4-bit nibble body (99.7% of residual levels fit [-8,7] on the
        # heavy bench streams) + escape (idx, val) repairs for the rest
        # — the dominant upload tensor scales with bitrate, and nibbles
        # halve it vs an int8 body
        if k:
            gi = rows[:, 9][:, None] + np.arange(n * n)[None, :]
            ck = coeff_pool[gi]                       # (k, n*n) int16
        else:
            ck = np.zeros((0, n * n), np.int16)
        cnib = (ck & 15).astype(np.uint8)             # two's-compl nibble
        Ssb = cfg.sb_caps[bi_] if (cfg.sb_caps and real_slots) else 0
        if Ssb:
            # coded-sub-block upload: (Ssb,8) nibble-pair bytes + (Ssb,)
            # int32 row index into the (K*nsb, 16) dense sub-block
            # layout; the device row-scatters, unpacks and re-tiles.
            # The nz mask uses the ORIGINAL values (a nibble can wrap a
            # nonzero like 16 to 0; its escape still needs the row).
            nsb = (n // 4) ** 2
            sbm = ck.reshape(k, n // 4, 4, n // 4, 4) \
                .transpose(0, 1, 3, 2, 4).reshape(k * nsb, 16)
            sbv = cnib.reshape(k, n // 4, 4, n // 4, 4) \
                .transpose(0, 1, 3, 2, 4).reshape(k * nsb, 16)
            nzidx = np.flatnonzero((sbm != 0).any(axis=1))
            assert nzidx.size <= Ssb, (cidx, log2, nzidx.size, Ssb)
            rb = np.zeros((Ssb, 8), np.uint8)
            # padding rows: unique out-of-bounds slots (mode='drop')
            rbi = K * nsb + np.arange(Ssb, dtype=np.int32)
            pk = sbv[nzidx]
            rb[:nzidx.size] = pk[:, 0::2] | (pk[:, 1::2] << 4)
            rbi[:nzidx.size] = nzidx
            t[f"rb_{cidx}_{log2}"] = rb
            t[f"rbi_{cidx}_{log2}"] = rbi
        else:
            c8 = np.zeros((K, n, n // 2), np.uint8)
            c8[:k] = (cnib[:, 0::2] | (cnib[:, 1::2] << 4)) \
                .reshape(k, n, n // 2)
            t[f"rc_{cidx}_{log2}"] = c8
        if E:
            flat = ck.reshape(-1)
            eidx = np.flatnonzero((flat < -8) | (flat > 7))
            assert eidx.size <= E, (cidx, log2, eidx.size, E)
            ridx = np.full(E, K * n * n, np.int32)    # dump element
            rval = np.zeros(E, np.int16)
            ridx[:eidx.size] = eidx
            rval[:eidx.size] = flat[eidx]
            t[f"re_i_{cidx}_{log2}"] = ridx
            t[f"re_v_{cidx}_{log2}"] = rval
        else:
            assert bool(((ck >= -8) & (ck <= 7)).all()), \
                "escape capacity 0 but levels outside [-8,7]"
        if cfg.res_kinds and cfg.res_kinds[bi_]:
            kd = np.zeros(K, np.int8)
            kd[:k] = np.where(rows[:, 7] != 0, 2,
                              np.where(rows[:, 6] != 0, 1, 0))
            t[f"rk_{cidx}_{log2}"] = kd
        qp = np.zeros(K, np.int32)
        qp[:k] = rows[:, 5]
        Wp_ = cfg.W // (1 if cidx == 0 else cfg.subw)
        Hp_ = cfg.H // (1 if cidx == 0 else cfg.subh)
        # CEIL lattice: dims need not be n-multiples (1080p with 16/32
        # TUs); must match _scatter_residual_slots' padded lattice
        ncols = -(-Wp_ // n)
        nslots = -(-Hp_ // n) * ncols
        slots = np.full(K, nslots, np.int32)          # dump row for padding
        if k:
            slots[:k] = (rows[:, 2] >> log2) * ncols + \
                (rows[:, 1] >> log2)
        t[f"rq_{cidx}_{log2}"] = qp
        t[f"rs_{cidx}_{log2}"] = slots


def _pack_pcm(t, plan, cfg):
    """PCM sample buckets: per coded log2, (Kp, n*n) luma + (Kp, 2*csz)
    interleaved [Cb|Cr] samples and CEIL-lattice slot rows (dump row for
    padding), scattered onto the zeroed PCM regions on device.

    Chroma geometry is per-axis (read_pcm_samples, slice.cc:4144-4215):
    4:2:0 one (n/2, n/2) square per block, 4:4:4 one (n, n), 4:2:2 a
    TALL (n, n/2) rect shipped as TWO stacked squares (two slot rows per
    block — the square scatter lattice stays); monochrome ships none."""
    tu_meta, _, pcm_pool = plan._tu_arrays
    dt = np.uint8 if cfg.bitdepth <= 8 else np.int16
    cat = cfg.chroma_fmt
    subw = 2 if cat in (1, 2) else 1
    subh = 2 if cat == 1 else 1
    sel_all = tu_meta[:, 0] == -1 if tu_meta.shape[0] else \
        np.zeros(0, bool)
    for (log2, Kp) in cfg.pcm:
        n = 1 << log2
        nn = n * n
        cw, chh = (n // subw, n // subh) if cat else (0, 0)
        csz = cw * chh
        m = sel_all & (tu_meta[:, 3] == log2) if tu_meta.shape[0] else \
            np.zeros(0, bool)
        rows = tu_meta[m]
        k = rows.shape[0]
        assert k <= Kp, (log2, k, Kp)
        py = np.zeros((Kp, nn), dt)
        if k:
            gi = rows[:, 9][:, None] + np.arange(nn)[None, :]
            py[:k] = pcm_pool[gi]
        ncols = -(-cfg.W // n)
        nslots = -(-cfg.H // n) * ncols
        slots = np.full(Kp, nslots, np.int32)
        if k:
            slots[:k] = (rows[:, 2] >> log2) * ncols + (rows[:, 1] >> log2)
        t[f"py_{log2}"] = py
        t[f"ps_{log2}"] = slots
        if not cat:
            continue
        pc = np.zeros((Kp, 2 * csz), dt)
        if k:
            gc = rows[:, 9][:, None] + nn + np.arange(2 * csz)[None, :]
            pc[:k] = pcm_pool[gc]
        s = n // 2 if cat == 2 else cw            # square side
        nsq = 2 if cat == 2 else 1
        ncols_c = -(-(cfg.W // subw) // s)
        nslots_c = -(-(cfg.H // subh) // s) * ncols_c
        slots_c = np.full(Kp * nsq, nslots_c, np.int32)
        if k:
            cx = rows[:, 1] // subw
            cy = rows[:, 2] // subh
            if cat == 2:
                slots_c[0:2 * k:2] = (cy // s) * ncols_c + cx // s
                slots_c[1:2 * k:2] = (cy // s + 1) * ncols_c + cx // s
            else:
                slots_c[:k] = (cy // s) * ncols_c + cx // s
        t[f"pc_{log2}"] = pc
        t[f"psc_{log2}"] = slots_c
    return t


# ----------------------------------------------------------- device pieces
BIT_KEYS = ("pm", "cbf", "off")          # 0/1 grids
BIT2_KEYS = ("tucb", "edgeall")          # 2-bit edge masks


def _unpack_bits(a, w):
    """(gh, ceil(w/8)) uint8 packed bits -> (gh, w) int32 0/1 (device).
    Matches numpy packbits' big bit order."""
    import jax.numpy as jnp
    gh, gwb = a.shape
    bits = (a[:, :, None].astype(jnp.int32)
            >> (7 - jnp.arange(8, dtype=jnp.int32))[None, None, :]) & 1
    return bits.reshape(gh, gwb * 8)[:, :w]


def _expand_ctb4(a, cfg):
    """CTB grid -> 4x4-block grid (device): broadcast-repeat + crop (no
    gather)."""
    import jax.numpy as jnp
    gh, gw = cfg.H // 4, cfg.W // 4
    f = 1 << (cfg.log2ctb - 2)
    h, w = a.shape
    return jnp.broadcast_to(a[:, None, :, None], (h, f, w, f)) \
        .reshape(h * f, w * f)[:gh, :gw]


def _expand_grid2(a, gh, gw):
    """8x8-granular grid -> 4x4 grid: uniform 2x repeat on both leading
    axes (broadcast-lowered, no gather); trailing dims untouched."""
    import jax.numpy as jnp
    return jnp.repeat(jnp.repeat(a, 2, axis=0), 2, axis=1)[:gh, :gw]


def _expand_mask(m, f, H, W):
    """(gh,gw) -> (H,W) with f-fold block expansion (f=4 luma, 2 chroma)."""
    return _expand_mask2(m, f, f, H, W)


def _expand_mask2(m, fy, fx, H, W):
    """Per-axis block expansion: 4:2:2 chroma scales 4x vertically but
    2x horizontally."""
    import jax.numpy as jnp
    gh, gw = m.shape
    return jnp.broadcast_to(m[:, None, :, None], (gh, fy, gw, fx)) \
        .reshape(gh * fy, gw * fx)[:H, :W]


def _scatter_residual_slots(plane, res, slots, log2, maxv):
    """Residual add via row-scatter with a dump row for padded entries.
    The slot lattice is CEIL-sized (matches pack_frame) so plane dims
    need not be n-multiples; the pad region only holds zero rows."""
    import jax.numpy as jnp
    H, W = plane.shape
    n = 1 << log2
    nrows, ncols = -(-H // n), -(-W // n)
    rows = res.reshape(res.shape[0], n * n)
    nslots = nrows * ncols
    table = jnp.zeros((nslots + 1, n * n), jnp.int32)
    table = table.at[slots].set(rows, unique_indices=True)
    rp = table[:nslots].reshape(nrows, ncols, n, n) \
        .transpose(0, 2, 1, 3).reshape(nrows * n, ncols * n)[:H, :W]
    return jnp.clip(plane + rp, 0, maxv)


def decode_frame_device(dy, dcb, dcr, ty, tc, t, out_slot,
                        cfg: ProgramCfg,
                        stages=("mc", "res", "intra", "dbk", "sao",
                                "tables")):
    """The fused program body (trace-time; wrap with jit via get_program).
    dy/dcb/dcr: (R,H,W)/(R,Hc,Wc) int16 device DPB stacks.
    ty/tc: persistent MC tile tables (init_tables; tc carries the
    interleaved [Cb|Cr] chroma rows), updated at DPB
    insert — MC reads them directly, so nothing is rebuilt per
    referencing frame. t: dict of device plan tensors (pack_frame with
    real_slots=True). out_slot: scalar i32.
    stages: which pipeline stages run (profiling ablation —
    tools/profile_frame_stages.py; "tables" = the insert-time table
    build). Production always uses the full default.
    Returns (dy', dcb', dcr', ty', tc')."""
    import jax.numpy as jnp
    from .ops.mc_tile_jax import mc_frame_tile

    H, W = cfg.H, cfg.W
    Hc, Wc = cfg.chroma_dims
    bd = cfg.bitdepth
    gh, gw = H // 4, W // 4
    N = gh * gw

    t = dict(t)
    if cfg.pack_bits:
        for k in BIT_KEYS:
            t[k] = _unpack_bits(t[k], gw)
        for k in BIT2_KEYS:
            a = t[k]
            t[k] = _unpack_bits(a[0], gw) | (_unpack_bits(a[1], gw) << 1)
        if cfg.qp_grid8:
            t["qp"] = _expand_grid2(t["qp"], gh, gw)
    if cfg.skip_mc:
        # zero-PU frame: no motion uploads — the deblock planner reads
        # all-zero grids (bS comes from the intra pm grid alone)
        t["mv"] = jnp.zeros((gh, gw, 2, 2), jnp.int32)
        t["poc"] = jnp.zeros((gh, gw, 2), jnp.int32)
        t["pf"] = jnp.zeros((gh, gw, 2), jnp.int32)
    if cfg.lane0 and not cfg.skip_mc:
        # re-widen the host-collapsed motion grids: duplicate lane1
        # (never consulted — pf1=0 keeps both MC and the bS planner on
        # their single-vector paths)
        t["mv"] = jnp.stack([t["mv"], t["mv"]], axis=2)
        for k in ("poc", "slot"):
            t[k] = jnp.stack([t[k], t[k]], axis=-1)
        t["pf"] = jnp.stack([t["pf"], jnp.zeros_like(t["pf"])], axis=-1)
    if cfg.pu_grid8 and not cfg.skip_mc:
        for k in (("mv", "poc", "pf", "slot", "ref_idx")
                  if cfg.has_weights else ("mv", "poc", "pf", "slot")):
            t[k] = _expand_grid2(t[k], gh, gw)

    if "mc" not in stages or cfg.skip_mc:
        Y = jnp.zeros((H, W), jnp.int32)
        Cb = jnp.zeros((Hc, Wc), jnp.int32)
        Cr = jnp.zeros((Hc, Wc), jnp.int32)
        return _finish_frame(dy, dcb, dcr, ty, tc, t, out_slot, cfg,
                             stages, Y, Cb, Cr)
    tables = (ty, tc)

    # ---- MC block arrays from grids (slot resolved on host at pack time)
    slot_g = t["slot"].astype(jnp.int32)                         # (gh,gw,2)
    pfg = t["pf"].astype(jnp.int32)
    mvg = t["mv"].astype(jnp.int32)
    swap = pfg[:, :, 0] == 0
    mv0 = jnp.where(swap[..., None], mvg[:, :, 1, :], mvg[:, :, 0, :])
    s0 = jnp.where(swap, slot_g[:, :, 1], slot_g[:, :, 0])
    pf_l = jnp.stack([pfg[:, :, 0] | pfg[:, :, 1],
                      pfg[:, :, 0] & pfg[:, :, 1]], axis=-1)
    mv = jnp.stack([mv0, mvg[:, :, 1, :]], axis=2).reshape(N, 2, 2)
    slot = jnp.stack([s0, slot_g[:, :, 1]], axis=-1).reshape(N, 2)
    pf = pf_l.reshape(N, 2)

    if cfg.has_weights:
        s4 = _expand_ctb4(t["sidx"].astype(jnp.int32), cfg)      # (gh,gw)
        ridx = t["ref_idx"].astype(jnp.int32)                    # (gh,gw,2)
        l2 = jnp.arange(2)[None, None, :]
        wtab = t["wt"]                          # (S1,2,16,3,2)
        den = t["wt_denom"]                     # (S1,3)
        w_g = wtab[s4[:, :, None], l2, ridx]    # (gh,gw,2,3,2)
        w0 = jnp.where(swap[..., None, None], w_g[:, :, 1], w_g[:, :, 0])
        w_l = jnp.stack([w0, w_g[:, :, 1]], axis=2)   # (gh,gw,2lane,3,2)
        dengrid = den[s4]                       # (gh,gw,3)
        wts = jnp.concatenate([
            w_l[:, :, 0].reshape(gh, gw, 3, 2),
            w_l[:, :, 1].reshape(gh, gw, 3, 2),
            dengrid[..., None]], axis=-1)       # (gh,gw,3,5): w0,o0,w1,o1,l2
        wts = wts.reshape(N, 3, 5)
        ex = (t["has_pw"][s4] != 0).reshape(N)
    else:
        wts = jnp.zeros((N, 3, 5), jnp.int32)
        ex = jnp.zeros((N,), bool)

    mcp = mc_frame_tile(tables, (H, W), mv, slot, pf, wts, ex, bd,
                        bi=cfg.has_bi,
                        mc_caps=cfg.mc_caps or None,
                        mc_caps_c=cfg.mc_caps_c or None,
                        luma_only=("mc_luma_only" in stages
                                   or cfg.chroma_fmt != 1),
                        weighted=cfg.has_weights)

    inter_m = t["pm"].astype(jnp.int32) == 0      # not intra (skip==inter)
    Y = jnp.where(_expand_mask(inter_m, 4, H, W), mcp[0], 0)
    if cfg.mono:
        Cb = jnp.zeros((Hc, Wc), jnp.int32)
        Cr = jnp.zeros((Hc, Wc), jnp.int32)
    elif cfg.chroma_fmt != 1:
        # 4:2:2/4:4:4: dense in-program epel straight from the chroma
        # DPB stacks (motion.cc:174-278 format scaling); the tile
        # tables stay luma-only for these formats
        from .ops.mc_tile_jax import mc_chroma_dense
        cbp, crp = mc_chroma_dense(dcb, dcr, mv, slot, pf, wts, ex,
                                   H, W, bd, bi=cfg.has_bi,
                                   weighted=cfg.has_weights)
        cm_ = _expand_mask2(inter_m, 4 // cfg.subh, 4 // cfg.subw,
                            Hc, Wc)
        Cb = jnp.where(cm_, cbp, 0)
        Cr = jnp.where(cm_, crp, 0)
    else:
        Cb = jnp.where(_expand_mask(inter_m, 2, Hc, Wc), mcp[1], 0)
        Cr = jnp.where(_expand_mask(inter_m, 2, Hc, Wc), mcp[2], 0)
    return _finish_frame(dy, dcb, dcr, ty, tc, t, out_slot, cfg,
                         stages, Y, Cb, Cr)


def _finish_frame(dy, dcb, dcr, ty, tc, t, out_slot, cfg, stages,
                  Y, Cb, Cr):
    """Residual add + loop filters + DPB/table insert (stage-gated tail)."""
    import jax.numpy as jnp
    from .ops.transform_jax import residual_batch
    bd = cfg.bitdepth
    maxv = (1 << bd) - 1

    # ---- residuals
    if "res" in stages:
        planes = [Y, Cb, Cr]
        for bi_, (cidx, log2, K) in enumerate(cfg.buckets):
            n = 1 << log2
            E = cfg.escapes[bi_] if cfg.escapes else 0
            Ssb = cfg.sb_caps[bi_] if cfg.sb_caps else 0
            def unnib(b):
                # 4-bit two's-complement nibble pairs -> int32
                lo = ((b & 15) << 28) >> 28
                hi = ((b >> 4) << 28) >> 28
                return jnp.stack([lo, hi], axis=-1)

            if Ssb:
                # unpack nibble pairs, then re-tile the coded
                # sub-blocks: one row scatter into the dense (K*nsb, 16)
                # layout (padding rows drop), then
                # (K, sy, sx, r, c) -> (K, n, n)
                nsb = (n // 4) ** 2
                rbv = unnib(t[f"rb_{cidx}_{log2}"].astype(jnp.int32)) \
                    .reshape(-1, 16)
                flatsb = jnp.zeros((K * nsb, 16), jnp.int32).at[
                    t[f"rbi_{cidx}_{log2}"]].set(
                    rbv, mode="drop", unique_indices=True)
                c = flatsb.reshape(K, n // 4, n // 4, 4, 4) \
                    .transpose(0, 1, 3, 2, 4).reshape(K, n, n)
            else:
                c = unnib(t[f"rc_{cidx}_{log2}"].astype(jnp.int32)) \
                    .reshape(K, n, n)
            if E:      # re-apply int16 escape values over the int8 body
                flat = jnp.concatenate(
                    [c.reshape(K * n * n), jnp.zeros(1, jnp.int32)])
                flat = flat.at[t[f"re_i_{cidx}_{log2}"]].set(
                    t[f"re_v_{cidx}_{log2}"].astype(jnp.int32))
                c = flat[:K * n * n].reshape(K, n, n)
            qpv = t[f"rq_{cidx}_{log2}"]
            if cfg.scaling:
                from .ops.transform_jax import (residual_batch_sl,
                                                dequant_batch_sl)
                smat = t[f"sm_{cidx}_{log2}"].astype(jnp.int32)
                res = residual_batch_sl(c, qpv, smat, log2, False, bd)
            else:
                res = residual_batch(c, qpv, log2, False, bd)
            kinds = cfg.res_kinds[bi_] if cfg.res_kinds else 0
            if kinds:
                # per-TU variant select: transform-skip (dequant + shift)
                # and/or tq-bypass (raw coeffs) — transform.cc:352-625.
                # XLA CSEs the duplicated dequant with residual_batch's.
                from .ops.transform_jax import (dequant_batch,
                                                transform_skip_batch)
                kd = t[f"rk_{cidx}_{log2}"].astype(jnp.int32)[:, None, None]
                if kinds & 1:
                    d = dequant_batch_sl(c, qpv, smat, log2, bd) \
                        if cfg.scaling else dequant_batch(c, qpv, log2, bd)
                    res = jnp.where(kd == 1,
                                    transform_skip_batch(d, log2, bd), res)
                if kinds & 2:
                    res = jnp.where(kd == 2, c, res)
            planes[cidx] = _scatter_residual_slots(
                planes[cidx], res, t[f"rs_{cidx}_{log2}"], log2, maxv)
        Y, Cb, Cr = planes

    # ---- PCM paste (before intra: PCM neighbors are level-0 borders).
    # The pm grid masked MC out of PCM regions and no TU scatters there,
    # so the add-scatter lands on zeros == an overwrite.
    if cfg.pcm and "res" in stages:
        cat = cfg.chroma_fmt
        subw = 2 if cat in (1, 2) else 1
        for (log2, Kp) in cfg.pcm:
            n = 1 << log2
            nn = n * n
            Y = _scatter_residual_slots(
                Y, t[f"py_{log2}"].astype(jnp.int32).reshape(Kp, n, n),
                t[f"ps_{log2}"], log2, maxv)
            if not cat:
                continue
            pc = t[f"pc_{log2}"].astype(jnp.int32)
            csz = pc.shape[1] // 2
            if cat == 2:
                # 4:2:2 tall (n, n/2) blocks scatter as 2 stacked
                # squares (psc carries 2 slot rows per block)
                s = n // 2
                def sq(a):
                    return a.reshape(Kp * 2, s, s)
                lg = log2 - 1
            else:
                s = n // subw
                def sq(a):
                    return a.reshape(Kp, s, s)
                lg = log2 - 1 if cat == 1 else log2
            Cb = _scatter_residual_slots(
                Cb, sq(pc[:, :csz]), t[f"psc_{log2}"], lg, maxv)
            Cr = _scatter_residual_slots(
                Cr, sq(pc[:, csz:]), t[f"psc_{log2}"], lg, maxv)

    # ---- fused intra wavefront (reads post-inter-residual neighbors,
    # exactly the reference's in-loop order: decode_TU slice.cc:3424)
    if cfg.intra and "intra" in stages:
        from .intra_fused import intra_stage
        Y, Cb, Cr = intra_stage(Y, Cb, Cr, t, cfg)

    # ---- loop filters (metadata derived on device)
    if "dbk" in stages:
        Y, Cb, Cr = deblock_planes(Y, Cb, Cr, t, cfg)
    if cfg.sao_enabled and "sao" in stages:
        Y, Cb, Cr = sao_planes(Y, Cb, Cr, t, cfg)

    # ---- DPB + tile-table insert
    dy = jax.lax.dynamic_update_slice(
        dy, Y.astype(jnp.int16)[None], (out_slot, 0, 0))
    dcb = jax.lax.dynamic_update_slice(
        dcb, Cb.astype(jnp.int16)[None], (out_slot, 0, 0))
    dcr = jax.lax.dynamic_update_slice(
        dcr, Cr.astype(jnp.int16)[None], (out_slot, 0, 0))
    if "tables" in stages:
        ty, tc = update_tables(ty, tc, Y, Cb, Cr, out_slot, cfg)
    return dy, dcb, dcr, ty, tc


def deblock_planes(Y, Cb, Cr, t, cfg: ProgramCfg):
    """Deblocking (V then H edges) of int32 planes from the unpacked
    filter grids `t` (device)."""
    from .ops.filter_plan_jax import plan_deblock_device
    from .ops.deblock_jax import deblock_luma_pass, deblock_chroma_pass
    bd = cfg.bitdepth
    lm, cm = plan_deblock_device(t, cfg.fcfg)
    for vi, vertical in enumerate((True, False)):
        Y = deblock_luma_pass(Y, *lm[vi], vertical=vertical, bitdepth=bd)
        if cm is not None:
            # map rows are 4x4-luma-granular; chroma lines per row
            # depend on the along-edge subsampling (4:2:2/4:4:4)
            rep = 4 // (cfg.subh if vertical else cfg.subw)
            act, tc_map, p_off, q_off = cm[vi]
            Cb = deblock_chroma_pass(Cb, act[0], tc_map[0], p_off, q_off,
                                     vertical=vertical, bitdepth=bd,
                                     rep=rep)
            Cr = deblock_chroma_pass(Cr, act[1], tc_map[1], p_off, q_off,
                                     vertical=vertical, bitdepth=bd,
                                     rep=rep)
    return Y, Cb, Cr


def sao_planes(Y, Cb, Cr, t, cfg: ProgramCfg):
    """SAO of int32 planes from the unpacked filter grids `t` (device)."""
    from .ops.filter_plan_jax import plan_sao_device
    from .ops.sao_jax import sao_apply
    outs = []
    for ci, P in enumerate((Y, Cb, Cr)):
        if ci and cfg.mono:
            outs.append(P)
            continue
        outs.append(sao_apply(P, *plan_sao_device(t, cfg.scfg, ci),
                              bitdepth=cfg.bitdepth))
    return tuple(outs)


_PROGRAMS = {}


def get_program(cfg: ProgramCfg):
    """Jitted fused program for a static config (cached)."""
    if cfg not in _PROGRAMS:
        def fn(dy, dcb, dcr, ty, tc, t, out_slot):
            return decode_frame_device(dy, dcb, dcr, ty, tc, t,
                                       out_slot, cfg)
        _PROGRAMS[cfg] = jax.jit(fn, donate_argnums=(0, 1, 2, 3, 4))
    return _PROGRAMS[cfg]


# ---------------------------------------------------- monolithic upload
def blob_meta(stacked):
    """Static layout for serializing a dict of stacked plan tensors into
    one flat buffer PER DTYPE: a scan batch ships as ~4 host->device
    transfers instead of ~20. Grouping by dtype keeps the device-side
    unpack to static slice+reshape only (no bitcasts).
    Returns a hashable ((key, dtype, shape, offset_elems), ...) tuple and
    a {dtype_str: total_elems} dict."""
    meta = []
    totals = {}
    for k in sorted(stacked):
        a = stacked[k]
        dt = a.dtype.str
        off = totals.get(dt, 0)
        meta.append((k, dt, a.shape, off))
        totals[dt] = off + int(a.size)
    return tuple(meta), totals


def pack_blob(stacked, meta, totals):
    """Host: {dtype_str: flat numpy array} — bools pack as uint8."""
    bufs = {dt: np.zeros(n, np.dtype(dt) if np.dtype(dt).kind != "b"
                         else np.uint8) for dt, n in totals.items()}
    for k, dt, shape, off in meta:
        a = stacked[k]
        bufs[dt][off:off + a.size] = a.reshape(-1)
    return bufs


def unpack_blob(bufs, meta):
    """Device: static slice + reshape back into the tensor dict (XLA
    folds these into the consumers — no materialized copies)."""
    out = {}
    for k, dt, shape, off in meta:
        n = int(np.prod(shape)) if shape else 1
        raw = bufs[dt][off:off + n]
        if np.dtype(dt).kind == "b":
            raw = raw != 0
        out[k] = raw.reshape(shape)
    return out


def pack_blob_native(plans, cfg: ProgramCfg, fid_slot, meta, totals,
                     out=None):
    """Pack an F-frame batch blob with the C++ front-end writers
    (native/frontend.cc fe_pack_frame) — the whole per-dtype buffer set
    is filled in one pass per frame with no numpy intermediates. Byte-
    identical to pack_frame+pack_blob (tests/test_native_pack.py).
    Returns None when the layout has keys the native side doesn't
    claim (weights / scaling / intra / pcm) or plans lack the native
    handle — caller falls back to numpy."""
    if not plans:
        return None
    fes = {getattr(p, "_fe", (None,))[0] for p in plans}
    if len(fes) != 1 or None in fes:
        return None
    fe = fes.pop()
    if cfg.pcm or cfg.scaling or cfg.intra:
        return None
    if not fe.pack_setup(cfg, meta, len(plans)):
        return None
    if out is not None:
        bufs = out          # e.g. shared-memory views: zero-copy handoff
        for a in bufs.values():
            a[:] = 0
    else:
        bufs = {dt: np.zeros(n, np.dtype(dt) if np.dtype(dt).kind != "b"
                             else np.uint8) for dt, n in totals.items()}
    for bi_, p in enumerate(plans):
        fe.pack_frame_into(p._fe[1], bi_, fid_slot, bufs)
    return bufs


_STREAM_PROGRAMS = {}


def get_stream_program(cfg: ProgramCfg):
    """Jitted multi-frame program: lax.scan of the frame body over stacked
    plan tensors — ONE dispatch decodes a whole run of frames, with the DPB
    stacks + MC tile tables as the donated scan carry. This is the
    deployment shape: the host uploads a batch of packed plans and the chip
    streams through them with no per-frame dispatch/queueing overhead.
    ts: dict of arrays stacked on a leading frame axis; out_slots: (F,)."""
    if cfg not in _STREAM_PROGRAMS:
        def fn(dy, dcb, dcr, ty, tc, ts, out_slots):
            def step(carry, xs):
                t, slot = xs
                return decode_frame_device(*carry, t, slot, cfg), 0
            carry, _ = jax.lax.scan(step, (dy, dcb, dcr, ty, tc),
                                    (ts, out_slots))
            return carry
        _STREAM_PROGRAMS[cfg] = jax.jit(fn, donate_argnums=(0, 1, 2, 3, 4))
    return _STREAM_PROGRAMS[cfg]


_BLOB_PROGRAMS = {}


def get_stream_program_blob(cfg: ProgramCfg, meta):
    """get_stream_program variant taking the scan batch as per-dtype flat
    blobs (+ (F,) out_slots): ~4 host->device transfers per batch instead
    of ~20, which matters on latency-bound links. meta from blob_meta."""
    key = (cfg, meta)
    if key not in _BLOB_PROGRAMS:
        def fn(dy, dcb, dcr, ty, tc, buf, out_slots):
            ts = unpack_blob(buf, meta)

            def step(carry, xs):
                t, slot = xs
                return decode_frame_device(*carry, t, slot, cfg), 0
            carry, _ = jax.lax.scan(step, (dy, dcb, dcr, ty, tc),
                                    (ts, out_slots))
            return carry
        _BLOB_PROGRAMS[key] = jax.jit(fn, donate_argnums=(0, 1, 2, 3, 4))
    return _BLOB_PROGRAMS[key]
