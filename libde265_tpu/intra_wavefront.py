"""Wavefront-level batching for intra prediction on the device.

Intra TUs read reconstructed neighbor pixels, which serializes them in z-scan
order. Instead of the reference's per-CTB sequential loop
(slice.cc:4664-4830), the host computes a dependency *level* for every TU
(longest chain of border dependencies); all TUs in one level are independent
and run as one batched device step. Levels advance like the WPP wavefront but
at TU granularity — the device analog of the reference's CTB-row wavefronts
(SURVEY §2.4).

Level assignment: maintain an int grid L over 4x4 blocks, initialized 0
(inter/PCM regions and out-of-frame are level 0 = "ready before any intra
step"). For each intra TU in decode order:
    lvl = 1 + max(L over the 4x4 blocks its border samples touch)
    set its own blocks' L to lvl.
This is exact: border samples only come from blocks earlier in z-order, whose
levels are final when visited.
"""
import numpy as np

from .plan import MODE_INTRA


def assign_levels(plan):
    """Returns (levels list parallel to plan.tus, n_levels). Non-intra TUs
    and PCM pastes get level 0 (done in the pre-pass)."""
    gh, gw = plan.gh, plan.gw
    # separate level grids per plane (chroma reads chroma neighbors)
    L = [np.zeros((gh, gw), np.int32) for _ in range(3)]
    levels = []
    n_levels = 0
    for tu in plan.tus:
        if tu.cidx == -1 or tu.pred_mode != MODE_INTRA:
            levels.append(0)
            if tu.cidx == -1:
                # PCM paste finalizes its blocks at level 0
                continue
            continue
        subw = 1 if tu.cidx == 0 else plan.sps.SubWidthC
        subh = 1 if tu.cidx == 0 else plan.sps.SubHeightC
        n = 1 << tu.log2
        # luma-grid coords of this TU's region (per-axis chroma scale)
        x0 = tu.x * subw
        y0 = tu.y * subh
        spanx, spany = n * subw, n * subh
        g = L[tu.cidx]
        gx0, gy0 = x0 >> 2, y0 >> 2
        gspanx = max(1, spanx >> 2)
        gspany = max(1, spany >> 2)
        # border source blocks: left column (x0-1, y0..y0+2n-1),
        # top row (x0-1..x0+2n-1, y0-1)
        dep = 0
        bx = (x0 - 1) >> 2
        if bx >= 0:
            y_end = min(gh - 1, (y0 + 2 * spany - 1) >> 2)
            dep = max(dep, int(g[gy0:y_end + 1, bx].max(initial=0)))
        by = (y0 - 1) >> 2
        if by >= 0:
            x_end = min(gw - 1, (x0 + 2 * spanx - 1) >> 2)
            dep = max(dep, int(g[by, max(0, bx):x_end + 1].max(initial=0)))
        lvl = dep + 1
        g[gy0:gy0 + gspany, gx0:gx0 + gspanx] = lvl
        levels.append(lvl)
        n_levels = max(n_levels, lvl)
    return levels, n_levels


def wavefront_stats(plan):
    """Host-side introspection: TUs per level (for batching diagnostics)."""
    levels, n = assign_levels(plan)
    hist = np.bincount(np.asarray(levels, np.int32), minlength=n + 1)
    return {"n_levels": n, "tus": len(levels), "per_level_mean":
            float(hist[1:].mean()) if n else 0.0, "hist": hist}
