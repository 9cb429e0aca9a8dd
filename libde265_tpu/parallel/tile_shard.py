"""Real multi-chip tile-column decode via shard_map.

HEVC tiles are the codec's spatial-partition axis (SURVEY §2.4): no
intra/MV prediction crosses a tile boundary, so reconstruction of each
tile column is independent given the (replicated) reference frames. The
in-loop filters DO cross tile boundaries when the PPS allows it
(/root/reference/libde265/deblock.cc:1020-1058, sao.cc:140-200) — here
that coupling is a 16-pixel halo exchange between neighbouring shards
(all_gather of boundary columns + one-hot select; ppermute is broken on
this build's CPU backend), after which each shard runs the same fused
filter chain on its halo-extended strip and keeps its own columns.
Boundary-strength metadata is derived per shard from halo-extended plan
grids with global CTB-table lookups (ops/filter_plan_jax.py xoff).

Each decoded frame is all-gathered into the replicated device DPB, so
any later MV can reference any tile. Bit-exactness vs the single-device
path: tests/test_tile_shard.py (golden MD5 on a virtual CPU mesh).
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from ..plan import MODE_INTRA
from ..frame_program import ProgramCfg, REF_SLOTS, pack_frame

HALO_Y = 16            # luma halo columns (covers every edge touching us)
HALO_C = 8             # chroma halo columns
GB = 4                 # 4x4-grid halo blocks (= HALO_Y/4)

SHARDED_KEYS = ("pm", "cbf", "tucb", "edgeall", "qp", "off", "pf", "mv",
                "poc", "slot")


def strip_geometry(plan, ndev):
    """Tile-column strip geometry from the PPS colBd (arbitrary, CTB
    units — pps.h:109-151): per-column pixel origins x0, valid pixel
    widths w, and the padded uniform strip width Ws (max column,
    CTB-sized). Uniform grids are the special case w[d] == Ws."""
    pps, sps = plan.pps, plan.sps
    ctb = 1 << sps.Log2CtbSizeY
    bd = pps.colBd                          # CTB units, len ndev+1
    assert pps.num_tile_columns == ndev
    x0 = [int(bd[d]) * ctb for d in range(ndev)]
    w = [min(int(bd[d + 1]) * ctb, plan.W) - x0[d] for d in range(ndev)]
    Ws = max(int(bd[d + 1] - bd[d]) for d in range(ndev)) * ctb
    return x0, w, Ws


def split_strips(plan, cfg, fid_slot, ndev):
    """Host: global pack_frame tensors -> (sharded-stack dict, replicated
    dict, x0w). Strips are the ndev tile columns, padded to the widest
    column (short strips carry dead right padding — their filter output
    there is cropped by the width-aware reassembly)."""
    t = pack_frame(plan, cfg, fid_slot)
    if cfg.pu_grid8:
        # the sharded program strips 4x4-granular grids: undo pack_frame's
        # 8x8 upload subsampling (escape keys stay; strip rc is rebuilt)
        for k in ("mv", "poc", "pf", "slot") + \
                (("ref_idx",) if cfg.has_weights else ()):
            t[k] = np.repeat(np.repeat(t[k], 2, axis=0), 2, axis=1)
    for bi_, (cidx, log2, K) in enumerate(cfg.buckets):
        t.pop(f"re_i_{cidx}_{log2}", None)
        t.pop(f"re_v_{cidx}_{log2}", None)
    x0s, ws, Ws = strip_geometry(plan, ndev)
    ws4 = Ws // 4
    tsh = {}
    # halo-extended 4x4 grids (right-pad covers the widest strip's span)
    for k in SHARDED_KEYS + (("ref_idx",) if cfg.has_weights else ()):
        g = t.pop(k)
        pad = [(0, 0)] * g.ndim
        pad[1] = (GB, GB + ws4)
        gp = np.pad(g, pad)
        tsh[k] = np.stack([gp[:, x0s[d] // 4:x0s[d] // 4 + ws4 + 2 * GB]
                           for d in range(ndev)])
    # residual buckets in strip coordinates
    tu_meta, coeff_pool, _ = plan._tu_arrays
    sel = (tu_meta[:, 9] >= 0) & (tu_meta[:, 8] != MODE_INTRA) \
        if tu_meta.shape[0] else np.zeros(0, bool)
    for cidx, log2, K in cfg.buckets:
        n = 1 << log2
        sub = 1 if cidx == 0 else 2
        Wsc = Ws // sub
        # CEIL lattice (matches frame_program._scatter_residual_slots)
        ncols = -(-Wsc // n)
        nslots = (-(-(cfg.H // sub) // n)) * ncols
        cs, qs, ss = [], [], []
        for d in range(ndev):
            x0c = x0s[d] // sub
            wc = ws[d] // sub
            if tu_meta.shape[0]:
                m = sel & (tu_meta[:, 0] == cidx) & (tu_meta[:, 3] == log2) \
                    & (tu_meta[:, 1] >= x0c) & (tu_meta[:, 1] < x0c + wc)
                rows = tu_meta[m]
            else:
                rows = np.zeros((0, 10), np.int32)
            k = rows.shape[0]
            assert k <= K
            coeffs = np.zeros((K, n, n), np.int16)
            if k:
                gi = rows[:, 9][:, None] + np.arange(n * n)[None, :]
                coeffs[:k] = coeff_pool[gi].reshape(k, n, n)
            qp = np.zeros(K, np.int32)
            qp[:k] = rows[:, 5]
            slots = np.full(K, nslots, np.int32)
            if k:
                slots[:k] = (rows[:, 2] >> log2) * ncols + \
                    ((rows[:, 1] - x0c) >> log2)
            cs.append(coeffs)
            qs.append(qp)
            ss.append(slots)
        t.pop(f"rc_{cidx}_{log2}", None)
        t.pop(f"rq_{cidx}_{log2}", None)
        t.pop(f"rs_{cidx}_{log2}", None)
        tsh[f"rc_{cidx}_{log2}"] = np.stack(cs)
        tsh[f"rq_{cidx}_{log2}"] = np.stack(qs)
        tsh[f"rs_{cidx}_{log2}"] = np.stack(ss)
    x0w = np.stack([np.asarray(x0s, np.int32),
                    np.asarray(ws, np.int32)], axis=1)
    return tsh, t, x0w


def _halo_concat(loc, halo, axis_name, ndev, wd):
    """Attach left/right halo columns from ring neighbours.
    loc: (H, Ws) local strip, VALID columns [0, wd) (wd traced; short
    strips of a non-uniform grid carry dead right padding). The right
    edge is sliced at the valid width and the neighbour's halo lands at
    lane halo+wd so the filter reads true cross-tile pixels."""
    i = jax.lax.axis_index(axis_name)
    Hh = loc.shape[0]
    redge = jax.lax.dynamic_slice(loc, (0, wd - halo), (Hh, halo))
    ar = jax.lax.all_gather(redge, axis_name)            # (ndev, H, halo)
    al = jax.lax.all_gather(loc[:, :halo], axis_name)
    ids = jnp.arange(ndev)
    oh_prev = (ids == i - 1).astype(loc.dtype)
    oh_next = (ids == i + 1).astype(loc.dtype)
    left = jnp.tensordot(oh_prev, ar, axes=1)
    right = jnp.tensordot(oh_next, al, axes=1)
    ext = jnp.concatenate([left, loc, jnp.zeros_like(right)], axis=1)
    return jax.lax.dynamic_update_slice(ext, right, (0, halo + wd))


def _expand_ctb4_strip(a, cfg, ws4h, x0):
    """Global CTB grid -> strip-local halo'd 4x4 grid (gh, ws4h)."""
    nctby, nctbx = a.shape
    sh = cfg.log2ctb - 2
    gh = cfg.H // 4
    ys = jnp.arange(gh) >> sh
    xs = jnp.clip((jnp.arange(ws4h) - GB + x0 // 4) >> sh, 0, nctbx - 1)
    return a[ys][:, xs]


def _assemble(g, Ws, widths, Wfull):
    """(H, ndev*Ws) tiled gather -> (H, Wfull): static width-aware concat
    of each strip's valid columns (uniform grids are a no-op slice)."""
    if all(w == Ws for w in widths) and len(widths) * Ws == Wfull:
        return g
    pieces = [g[:, d * Ws:d * Ws + w] for d, w in enumerate(widths)]
    return jnp.concatenate(pieces, axis=1)[:, :Wfull]


def _expand_mask_strip(m, f, rows, cols):
    gh, gw = m.shape
    return jnp.broadcast_to(m[:, None, :, None], (gh, f, gw, f)) \
        .reshape(gh * f, gw * f)[:rows, :cols]


def decode_frame_tiles_local(dy, dcb, dcr, t, x0a, out_slot, cfg, ndev,
                             Ws, widths, axis="t"):
    """Per-shard body (inside shard_map). t: merged sharded(+squeezed) and
    replicated tensors. x0a: (1,2) [strip pixel origin, valid width] —
    strips are padded to the widest tile column Ws (static). Returns
    updated stacks (replicated)."""
    from ..ops.mc_tile_jax import build_tables, mc_frame_tile
    from ..ops.transform_jax import residual_batch
    from ..ops.filter_plan_jax import plan_deblock_device, plan_sao_device
    from ..ops.deblock_jax import deblock_luma_pass, deblock_chroma_pass
    from ..ops.sao_jax import sao_apply
    from ..frame_program import _scatter_residual_slots

    H, W = cfg.H, cfg.W
    Hc, Wsc = H // 2, Ws // 2
    bd = cfg.bitdepth
    maxv = (1 << bd) - 1
    gh = H // 4
    ws4 = Ws // 4
    N = gh * ws4
    x0 = x0a[0, 0]
    wd = x0a[0, 1]

    sel = t["sel_slots"]
    tables = build_tables(dy[sel], dcb[sel], dcr[sel], bitdepth=cfg.bitdepth)

    # ---- MC block arrays from the halo'd grids' center
    c = slice(GB, GB + ws4)
    slot_g = t["slot"][:, c].astype(jnp.int32)
    pfg = t["pf"][:, c].astype(jnp.int32)
    mvg = t["mv"][:, c].astype(jnp.int32)
    swap = pfg[:, :, 0] == 0
    mv0 = jnp.where(swap[..., None], mvg[:, :, 1, :], mvg[:, :, 0, :])
    s0 = jnp.where(swap, slot_g[:, :, 1], slot_g[:, :, 0])
    pf_l = jnp.stack([pfg[:, :, 0] | pfg[:, :, 1],
                      pfg[:, :, 0] & pfg[:, :, 1]], axis=-1)
    mv = jnp.stack([mv0, mvg[:, :, 1, :]], axis=2).reshape(N, 2, 2)
    slot = jnp.stack([s0, slot_g[:, :, 1]], axis=-1).reshape(N, 2)
    pf = pf_l.reshape(N, 2)
    if cfg.has_weights:
        s4 = _expand_ctb4_strip(t["sidx"].astype(jnp.int32), cfg,
                                ws4 + 2 * GB, x0)[:, c]
        ridx = t["ref_idx"][:, c].astype(jnp.int32)
        l2 = jnp.arange(2)[None, None, :]
        w_g = t["wt"][s4[:, :, None], l2, ridx]
        w0 = jnp.where(swap[..., None, None], w_g[:, :, 1], w_g[:, :, 0])
        w_l = jnp.stack([w0, w_g[:, :, 1]], axis=2)
        dengrid = t["wt_denom"][s4]
        wts = jnp.concatenate([
            w_l[:, :, 0].reshape(gh, ws4, 3, 2),
            w_l[:, :, 1].reshape(gh, ws4, 3, 2),
            dengrid[..., None]], axis=-1).reshape(N, 3, 5)
        ex = (t["has_pw"][s4] != 0).reshape(N)
    else:
        wts = jnp.zeros((N, 3, 5), jnp.int32)
        ex = jnp.zeros((N,), bool)

    mcp = mc_frame_tile(tables, (H, W), mv, slot, pf, wts, ex, bd,
                        strip=Ws, x0=x0)
    inter_m = t["pm"][:, c].astype(jnp.int32) == 0
    Y = jnp.where(_expand_mask_strip(inter_m, 4, H, Ws), mcp[0], 0)
    Cb = jnp.where(_expand_mask_strip(inter_m, 2, Hc, Wsc), mcp[1], 0)
    Cr = jnp.where(_expand_mask_strip(inter_m, 2, Hc, Wsc), mcp[2], 0)

    planes = [Y, Cb, Cr]
    for cidx, log2, K in cfg.buckets:
        res = residual_batch(t[f"rc_{cidx}_{log2}"].astype(jnp.int32),
                             t[f"rq_{cidx}_{log2}"], log2, False, bd)
        planes[cidx] = _scatter_residual_slots(
            planes[cidx], res, t[f"rs_{cidx}_{log2}"], log2, maxv)
    Y, Cb, Cr = planes

    # ---- halo exchange of pre-filter boundary pixels
    Ye = _halo_concat(Y, HALO_Y, axis, ndev, wd)
    Cbe = _halo_concat(Cb, HALO_C, axis, ndev, wd // 2)
    Cre = _halo_concat(Cr, HALO_C, axis, ndev, wd // 2)

    # ---- deblock on the halo-extended strip (metadata strip-local)
    lm, cm = plan_deblock_device(t, cfg.fcfg, xoff=x0 - HALO_Y)
    for vi, vertical in enumerate((True, False)):
        Ye = deblock_luma_pass(Ye, *lm[vi], vertical=vertical, bitdepth=bd)
        if cm is not None:
            act, tc, p_off, q_off = cm[vi]
            Cbe = deblock_chroma_pass(Cbe, act[0], tc[0], p_off, q_off,
                                      vertical=vertical, bitdepth=bd)
            Cre = deblock_chroma_pass(Cre, act[1], tc[1], p_off, q_off,
                                      vertical=vertical, bitdepth=bd)

    # ---- SAO on the extended strip (reads 1-px deblocked halo)
    if cfg.sao_enabled:
        outs = []
        for ci, Pl in enumerate((Ye, Cbe, Cre)):
            maps = plan_sao_device(t, cfg.scfg, ci, xoff=x0 - HALO_Y)
            outs.append(sao_apply(Pl, *maps, bitdepth=bd))
        Ye, Cbe, Cre = outs

    Y = Ye[:, HALO_Y:HALO_Y + Ws]
    Cb = Cbe[:, HALO_C:HALO_C + Wsc]
    Cr = Cre[:, HALO_C:HALO_C + Wsc]

    # ---- gather the strips, reassemble width-aware (short strips drop
    # their dead right padding), insert into the replicated DPB
    Yf = _assemble(jax.lax.all_gather(Y, axis, axis=1, tiled=True),
                   Ws, widths, W)
    Cbf = _assemble(jax.lax.all_gather(Cb, axis, axis=1, tiled=True),
                    Wsc, tuple(w // 2 for w in widths), W // 2)
    Crf = _assemble(jax.lax.all_gather(Cr, axis, axis=1, tiled=True),
                    Wsc, tuple(w // 2 for w in widths), W // 2)
    slot_s = out_slot[0]
    dy = jax.lax.dynamic_update_slice(dy, Yf.astype(jnp.int16)[None],
                                      (slot_s, 0, 0))
    dcb = jax.lax.dynamic_update_slice(dcb, Cbf.astype(jnp.int16)[None],
                                       (slot_s, 0, 0))
    dcr = jax.lax.dynamic_update_slice(dcr, Crf.astype(jnp.int16)[None],
                                       (slot_s, 0, 0))
    return dy, dcb, dcr


_SHARD_PROGRAMS = {}


def get_sharded_program(cfg: ProgramCfg, mesh: Mesh, widths=None):
    """widths: per-column valid pixel widths (static tuple; defaults to
    the uniform W/ndev grid). Ws = max(widths)."""
    ndev = mesh.shape["t"]
    if widths is None:
        widths = (cfg.W // ndev,) * ndev
    widths = tuple(widths)
    Ws = max(widths)
    key = (cfg, tuple(mesh.shape.items()), widths)
    if key in _SHARD_PROGRAMS:
        return _SHARD_PROGRAMS[key]

    def run(dy, dcb, dcr, tsh, trep, x0s, out_slot):
        def body(dy, dcb, dcr, tsh_l, trep_l, x0a, oslot):
            t = {k: v[0] for k, v in tsh_l.items()}
            t.update(trep_l)
            return decode_frame_tiles_local(dy, dcb, dcr, t, x0a, oslot,
                                            cfg, ndev, Ws, widths)
        kw = dict(mesh=mesh,
                  in_specs=(P(), P(), P(), P("t"), P(), P("t"), P()),
                  out_specs=(P(), P(), P()))
        try:
            sm = shard_map(body, check_vma=False, **kw)
        except TypeError:  # pre-0.8 jax spelling
            sm = shard_map(body, check_rep=False, **kw)
        return sm(dy, dcb, dcr, tsh, trep, x0s, out_slot)

    prog = jax.jit(run, donate_argnums=(0, 1, 2))
    _SHARD_PROGRAMS[key] = prog
    return prog
