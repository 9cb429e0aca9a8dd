"""Host-side packing of a FramePlan into dense device plan tensors.

The native front-end already fills resolution-shaped numpy grids
(plan.mv/pred_flag/qp_y/...); this module derives the remaining per-frame
tensors the fused device frame program consumes:

  - MC block arrays (mv/slot/pf/weights per 4x4 block) from the dense
    grids + per-slice ref-list tables (no per-PU python loops)
  - loop-filter planning grids (ops/filter_plan_jax.py input contract)
  - TU residual batches bucketed by size class with static padded shapes

Everything here is vectorized numpy on arrays the front-end produced —
O(pixels/16) with small constants, no python-per-block loops.
"""
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .plan import MODE_INTRA


def slice_tables(plan):
    """Per-slice parameter table + CTB->slice-row index grid.
    Returns dict of (S+1,) arrays (last row = sentinel for unmapped CTBs:
    filters disabled) and sidx (nctby, nctbx) int32."""
    shs = plan.slice_headers
    S = len(shs)
    seg2row = {int(s.slice_segment_address): i for i, s in enumerate(shs)}
    sidx = np.full((plan.nctby, plan.nctbx), S, np.int32)
    seg = plan.ctb_slice_seg
    for addr, row in seg2row.items():
        sidx[seg == addr] = row

    def tab(f, default):
        return np.asarray([f(s) for s in shs] + [default], np.int32)

    return {
        "sidx": sidx,
        "sh_disable": tab(lambda s: 1 if s.slice_deblocking_filter_disabled_flag else 0, 1),
        "sh_beta": tab(lambda s: s.slice_beta_offset, 0),
        "sh_tc": tab(lambda s: s.slice_tc_offset, 0),
        "sh_across": tab(lambda s: 1 if s.slice_loop_filter_across_slices_enabled_flag else 0, 1),
        "sh_sao_luma": tab(lambda s: 1 if s.slice_sao_luma_flag else 0, 0),
        "sh_sao_chroma": tab(lambda s: 1 if s.slice_sao_chroma_flag else 0, 0),
    }


def ctb_allow_masks(plan, tabs):
    """CTB-granular edge permissions (deblock) and neighbor-pair SAO
    availability — vectorized mirror of deblock_ref._edge_enabled and
    sao_jax._neighbor_avail_maps' CTB logic."""
    pps = plan.pps
    nctby, nctbx = plan.nctby, plan.nctbx
    tid = np.asarray(pps.TileId).reshape(nctby, nctbx)
    sa = plan.slice_addr_rs
    across_tiles = bool(pps.loop_filter_across_tiles_enabled_flag)
    sh_across = tabs["sh_across"]
    sidx = tabs["sidx"]

    def pair(cy, cx, ny, nx):
        """allowed(cur, neighbor) for deblock (q-side flag only)."""
        ok = np.ones(cy.shape, bool)
        tile_diff = tid[cy, cx] != tid[ny, nx]
        if not across_tiles:
            ok &= ~tile_diff
        slice_diff = sa[cy, cx] != sa[ny, nx]
        q_across = sh_across[sidx[cy, cx]] != 0
        ok &= ~(slice_diff & ~q_across)
        return ok

    ys, xs = np.mgrid[0:nctby, 0:nctbx]
    allow_v = np.zeros((nctby, nctbx), bool)      # left edge of each CTB
    allow_v[:, 1:] = pair(ys[:, 1:], xs[:, 1:], ys[:, 1:], xs[:, 1:] - 1)
    allow_h = np.zeros((nctby, nctbx), bool)      # top edge
    allow_h[1:, :] = pair(ys[1:, :], xs[1:, :], ys[1:, :] - 1, xs[1:, :])

    def sao_pair(cy, cx, ny, nx):
        """SAO availability checks BOTH sides' across flags
        (sao_jax._neighbor_avail_maps / reference sao.cc:140-200)."""
        ok = np.ones(cy.shape, bool)
        tile_diff = tid[cy, cx] != tid[ny, nx]
        if not across_tiles:
            ok &= ~tile_diff
        slice_diff = sa[cy, cx] != sa[ny, nx]
        a1 = sh_across[sidx[cy, cx]] != 0
        a2 = sh_across[sidx[ny, nx]] != 0
        ok &= ~(slice_diff & ~(a1 & a2))
        return ok

    pair_ok = np.zeros((4, nctby, nctbx), bool)
    pair_ok[0, :, 1:] = sao_pair(ys[:, 1:], xs[:, 1:], ys[:, 1:], xs[:, 1:] - 1)
    pair_ok[1, :, :-1] = sao_pair(ys[:, :-1], xs[:, :-1], ys[:, :-1], xs[:, :-1] + 1)
    pair_ok[2, 1:, :] = sao_pair(ys[1:, :], xs[1:, :], ys[1:, :] - 1, xs[1:, :])
    pair_ok[3, :-1, :] = sao_pair(ys[:-1, :], xs[:-1, :], ys[:-1, :] + 1, xs[:-1, :])
    return allow_v, allow_h, pair_ok


def _poc_delta16(ref_poc, cur_poc):
    d = ref_poc.astype(np.int64) - int(cur_poc)
    assert np.abs(d).max(initial=0) < 32768, "ref POC distance overflows i16"
    return d.astype(np.int16)


def build_filter_grids(plan):
    """Assemble the ops/filter_plan_jax grids dict (host numpy)."""
    sps = plan.sps
    tabs = slice_tables(plan)
    allow_v, allow_h, pair_ok = ctb_allow_masks(plan, tabs)
    off = plan.tq_bypass.astype(np.uint8)
    if sps.pcm_loop_filter_disable_flag:
        off = off | plan.pcm_flag
    grids = {
        "pm": (plan.pred_mode == MODE_INTRA).astype(np.uint8),
        "cbf": plan.cbf_luma,
        "tucb": plan.tu_boundary | plan.cb_boundary,
        "edgeall": plan.tu_boundary | plan.cb_boundary | plan.pb_boundary,
        # smallest dtypes that hold the values: these grids dominate the
        # per-frame host->device upload, and
        # every consumer casts to int32 on device anyway
        "qp": plan.qp_y.astype(np.int8),
        "off": off,
        "pf": plan.pred_flag,
        "mv": plan.mv,
        # POC as delta-from-current: the filter planners only compare ref
        # POCs of the same frame (equality + ordering), both preserved by
        # the shift, and deltas fit int16 (ref distance << 2^15)
        "poc": _poc_delta16(plan.ref_poc, plan.poc),
        "allow_v": allow_v,
        "allow_h": allow_h,
        "pair_ok": pair_ok,
        "sao_type": plan.sao.type_idx,
        "sao_eo": plan.sao.eo_class,
        "sao_band": plan.sao.band_pos,
        "sao_off": plan.sao.offsets,
    }
    grids.update(tabs)
    return grids


def filter_cfg(plan):
    sps, pps = plan.sps, plan.pps
    return (sps.Log2CtbSizeY, bool(sps.pcm_loop_filter_disable_flag),
            sps.ChromaArrayType, sps.BitDepthY, sps.BitDepthC,
            pps.pic_cb_qp_offset, pps.pic_cr_qp_offset, plan.H, plan.W)


def sao_cfg(plan):
    sps = plan.sps
    return (sps.Log2CtbSizeY, sps.ChromaArrayType, plan.H, plan.W,
            sps.SubWidthC, sps.SubHeightC)
