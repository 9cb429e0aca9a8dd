"""Differential test: tile-table MC (ops/mc_tile_jax) vs the proven dense
MC (ops/inter_dense_jax) on random motion fields, including far
out-of-range MVs (edge-clip path), bi-pred, weighted pred, and 10-bit.
The dense path is itself bit-exact vs the numpy reference on all golden
vectors, so agreement here transfers that guarantee."""
import os

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")


def _rand_case(seed, H, W, R, bitdepth, weighted, wild_mv):
    rng = np.random.RandomState(seed)
    maxv = (1 << bitdepth) - 1
    refs_y = rng.randint(0, maxv + 1, (R, H, W)).astype(np.int32)
    refs_cb = rng.randint(0, maxv + 1, (R, H // 2, W // 2)).astype(np.int32)
    refs_cr = rng.randint(0, maxv + 1, (R, H // 2, W // 2)).astype(np.int32)
    N = (H // 4) * (W // 4)
    lim = 1 << 14 if wild_mv else 64
    mv = rng.randint(-lim, lim, (N, 2, 2)).astype(np.int32)
    slot = rng.randint(0, R, (N, 2)).astype(np.int32)
    pf = np.zeros((N, 2), np.int32)
    pf[:, 0] = 1
    pf[:, 1] = rng.randint(0, 2, N)
    wts = np.zeros((N, 3, 5), np.int32)
    ex = np.zeros(N, bool)
    if weighted:
        ex[:] = rng.randint(0, 2, N) > 0
        denom = 6 + 14 - bitdepth
        wts[:, :, 4] = denom
        wts[:, :, 0] = rng.randint(30, 90, (N, 1))
        wts[:, :, 2] = rng.randint(30, 90, (N, 1))
        wts[:, :, 1] = rng.randint(-20, 20, (N, 1))
        wts[:, :, 3] = rng.randint(-20, 20, (N, 1))
    return refs_y, refs_cb, refs_cr, mv, slot, pf, wts, ex


@pytest.mark.parametrize("seed,bitdepth,weighted,wild_mv", [
    (0, 8, False, False),
    (1, 8, False, True),
    (2, 8, True, False),
    (3, 10, False, True),
    (4, 10, True, False),
])
def test_mc_tile_matches_dense(seed, bitdepth, weighted, wild_mv):
    import jax.numpy as jnp
    from libde265_tpu.ops.inter_dense_jax import mc_dense
    from libde265_tpu.ops.mc_tile_jax import _mc_standalone
    H, W = 64, 96
    R = 2
    refs_y, refs_cb, refs_cr, mv, slot, pf, wts, ex = _rand_case(
        seed, H, W, R, bitdepth, weighted, wild_mv)
    a = mc_dense(jnp.asarray(refs_y), jnp.asarray(refs_cb),
                 jnp.asarray(refs_cr), jnp.asarray(mv), jnp.asarray(slot),
                 jnp.asarray(pf), jnp.asarray(wts), jnp.asarray(ex), bitdepth)
    b = _mc_standalone(jnp.asarray(refs_y), jnp.asarray(refs_cb),
                       jnp.asarray(refs_cr), jnp.asarray(mv),
                       jnp.asarray(slot), jnp.asarray(pf), jnp.asarray(wts),
                       jnp.asarray(ex), (H, W), bitdepth)
    for ci in range(3):
        aa, bb = np.asarray(a[ci]), np.asarray(b[ci])
        assert aa.shape == bb.shape
        if not np.array_equal(aa, bb):
            bad = np.argwhere(aa != bb)
            raise AssertionError(
                f"plane {ci}: {len(bad)} mismatches, first at {bad[0]} "
                f"{aa[tuple(bad[0])]} vs {bb[tuple(bad[0])]}")


@pytest.mark.parametrize("seed,bitdepth,weighted", [
    (0, 8, False), (1, 8, True), (2, 10, False),
])
def test_mc_mxu_matches_vpu(seed, bitdepth, weighted):
    """The class-masked matmul luma MC (ops/mc_mxu_jax) must agree
    bit-for-bit with the elementwise tap passes, incl. wild MVs (edge clamp),
    bi-pred, weighted pred, 10-bit, and per-stream class capacities."""
    import jax.numpy as jnp
    from libde265_tpu.ops.mc_tile_jax import build_tables, mc_frame_tile
    from libde265_tpu.ops.mc_mxu_jax import (caps_from_counts,
                                             luma_class_counts)
    H, W = 64, 128
    refs_y, refs_cb, refs_cr, mv, slot, pf, wts, ex = _rand_case(
        seed, H, W, 4, bitdepth, weighted, True)
    N = mv.shape[0]
    # replicate the device's lane-0 swap for the capacity analysis
    swap = (pf[:, 0] == 0)[:, None]
    l0 = np.where(swap, mv[:, 1, :], mv[:, 0, :])
    hmax = np.zeros(16, np.int64)
    vmax = np.zeros(16, np.int64)
    for lane_mv in (l0, mv[:, 1, :]):
        hc, vc = luma_class_counts(lane_mv.astype(np.int64), H, W)
        hmax = np.maximum(hmax, hc)
        vmax = np.maximum(vmax, vc)
    caps = caps_from_counts(hmax, vmax)
    tabs = build_tables(jnp.asarray(refs_y), jnp.asarray(refs_cb),
                        jnp.asarray(refs_cr), bitdepth=bitdepth)
    args = (tabs, (H, W), jnp.asarray(mv), jnp.asarray(slot),
            jnp.asarray(pf), jnp.asarray(wts), jnp.asarray(ex), bitdepth)
    a = mc_frame_tile(*args)
    b = mc_frame_tile(*args, mc_caps=caps)
    for ci in range(3):
        aa, bb = np.asarray(a[ci]), np.asarray(b[ci])
        if not np.array_equal(aa, bb):
            bad = np.argwhere(aa != bb)
            raise AssertionError(
                f"plane {ci}: {len(bad)} mismatches, first at {bad[0]} "
                f"{aa[tuple(bad[0])]} vs {bb[tuple(bad[0])]}")


@pytest.mark.parametrize("mode", ["const", "hconst", "vconst"])
def test_mc_mxu_single_class_shortcuts(mode):
    """Constant-phase streams take the mask-free matmul shortcuts; they
    must stay bit-exact vs the elementwise tap path."""
    import jax.numpy as jnp
    from libde265_tpu.ops.mc_tile_jax import build_tables, mc_frame_tile
    from libde265_tpu.ops.mc_mxu_jax import (caps_from_counts,
                                             luma_class_counts)
    H, W = 64, 128
    refs_y, refs_cb, refs_cr, mv, slot, pf, wts, ex = _rand_case(
        5, H, W, 2, 8, False, False)
    if mode == "const":
        mv[:, :, 0] = -21          # one global qpel MV
        mv[:, :, 1] = 13
    elif mode == "hconst":
        mv[:, :, 0] = 8            # constant full-pel x -> single h-class
    else:
        mv[:, :, 1] = -12          # constant full-pel y -> single v-class
    hmax = np.zeros(16, np.int64)
    vmax = np.zeros(16, np.int64)
    for lane_mv in (mv[:, 0, :], mv[:, 1, :]):
        hc, vc = luma_class_counts(lane_mv.astype(np.int64), H, W)
        hmax = np.maximum(hmax, hc)
        vmax = np.maximum(vmax, vc)
    caps = caps_from_counts(hmax, vmax)
    if mode == "const":
        assert sum(1 for c in caps[0] if c) == 1
        assert sum(1 for c in caps[1] if c) == 1
    tabs = build_tables(jnp.asarray(refs_y), jnp.asarray(refs_cb),
                        jnp.asarray(refs_cr), bitdepth=8)
    args = (tabs, (H, W), jnp.asarray(mv), jnp.asarray(slot),
            jnp.asarray(pf), jnp.asarray(wts), jnp.asarray(ex), 8)
    a = mc_frame_tile(*args)
    b = mc_frame_tile(*args, mc_caps=caps)
    for ci in range(3):
        assert (np.asarray(a[ci]) == np.asarray(b[ci])).all(), ci


@pytest.mark.parametrize("seed,bitdepth,weighted", [
    (0, 8, False), (1, 8, True), (2, 10, False), (3, 8, False),
])
def test_mc_chroma_mxu_matches_vpu(seed, bitdepth, weighted):
    """The paired Cb|Cr class-masked matmul chroma MC (ops/mc_mxu_jax
    .mc_chroma_mxu) must agree bit-for-bit with the elementwise epel passes,
    incl. wild MVs (edge clamp), bi-pred, weighted pred, 10-bit."""
    import jax.numpy as jnp
    from libde265_tpu.ops.mc_tile_jax import build_tables, mc_frame_tile
    from libde265_tpu.ops.mc_mxu_jax import (caps_from_counts,
                                             chroma_class_counts, NCLS_C)
    H, W = 64, 128
    refs_y, refs_cb, refs_cr, mv, slot, pf, wts, ex = _rand_case(
        seed, H, W, 4, bitdepth, weighted, True)
    swap = (pf[:, 0] == 0)[:, None]
    l0 = np.where(swap, mv[:, 1, :], mv[:, 0, :])
    hmax = np.zeros(NCLS_C, np.int64)
    vmax = np.zeros(NCLS_C, np.int64)
    for lane_mv in (l0, mv[:, 1, :]):
        hc, vc = chroma_class_counts(lane_mv.astype(np.int64), H, W)
        hmax = np.maximum(hmax, hc)
        vmax = np.maximum(vmax, vc)
    caps_c = caps_from_counts(hmax, vmax)
    tabs = build_tables(jnp.asarray(refs_y), jnp.asarray(refs_cb),
                        jnp.asarray(refs_cr), bitdepth=bitdepth)
    args = (tabs, (H, W), jnp.asarray(mv), jnp.asarray(slot),
            jnp.asarray(pf), jnp.asarray(wts), jnp.asarray(ex), bitdepth)
    a = mc_frame_tile(*args)
    b = mc_frame_tile(*args, mc_caps_c=caps_c)
    for ci in range(3):
        aa, bb = np.asarray(a[ci]), np.asarray(b[ci])
        if not np.array_equal(aa, bb):
            bad = np.argwhere(aa != bb)
            raise AssertionError(
                f"plane {ci}: {len(bad)} mismatches, first at {bad[0]} "
                f"{aa[tuple(bad[0])]} vs {bb[tuple(bad[0])]}")


def _tile_table_np(padded, T):
    """Row-layout oracle: one row per stride-4 TxT tile, element
    [c*T + r] = tile[r, c]."""
    from numpy.lib.stride_tricks import sliding_window_view
    R, Hp, Wp = padded.shape
    nty, ntx = (Hp - (T - 4)) // 4, (Wp - (T - 4)) // 4
    win = sliding_window_view(padded, (T, T), axis=(1, 2))
    tiles = win[:, 0:4 * nty:4, 0:4 * ntx:4][:, :nty, :ntx]   # (R,ty,tx,r,c)
    return tiles.transpose(0, 1, 2, 4, 3).reshape(R * nty * ntx, T * T)


@pytest.mark.parametrize("T,dt", [(16, "uint8"), (8, "uint8"),
                                  (16, "int16"), (8, "int16")])
def test_tile_table_builder_matches_row_layout(T, dt):
    """build_tile_table_y/_c emit exactly the stride-4 tile rows of the
    padded planes (luma T=16, chroma T=8; uint8 and int16 tables)."""
    import jax.numpy as jnp
    from libde265_tpu.ops.mc_tile_jax import (build_tile_table_y,
                                              build_tile_table_c,
                                              n_tiles_y, n_tiles_c)
    rng = np.random.RandomState(T)
    H, W = 72, 136
    pad = 16 if T == 16 else 8
    hi = 256 if dt == "uint8" else 1024
    padded = rng.randint(0, hi, (2, H + 2 * pad, W + 2 * pad)) \
        .astype(np.int16)
    fn = build_tile_table_y if T == 16 else build_tile_table_c
    got = np.asarray(fn(jnp.asarray(padded), getattr(jnp, dt)))
    nty, ntx = (n_tiles_y if T == 16 else n_tiles_c)(H, W)
    assert got.shape == (2 * nty * ntx, T * T)
    assert got.dtype == np.dtype(dt)
    np.testing.assert_array_equal(got, _tile_table_np(padded, T)
                                  .astype(dt))


@pytest.mark.parametrize("mf,name", [("manifest_inter.json", "p_mv"),
                                     ("manifest_rext.json",
                                      "rext_444_inter")])
def test_update_tables_writes_only_its_slot(mf, name):
    """update_tables rebuilds one DPB slot's tile rows (luma + the
    interleaved Cb|Cr rows for 4:2:0, luma only otherwise) and leaves
    every other slot's rows untouched."""
    import jax
    import jax.numpy as jnp
    from libde265_tpu.api import parse_stream_native
    from libde265_tpu.frame_program import (REF_SLOTS, stream_cfg,
                                            table_geom, update_tables)
    from libde265_tpu.ops.mc_tile_jax import (build_tile_table_y,
                                              build_tables, PAD_Y)
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        plans = parse_stream_native(f.read())
    cfg = stream_cfg(plans, plans[0].sps)
    (ry, wy), (rc, wc), dt = table_geom(cfg)
    Hc, Wc = cfg.chroma_dims
    rng = np.random.RandomState(3)
    ty0 = rng.randint(0, 200, (REF_SLOTS * ry, wy)).astype(dt)
    tc0 = rng.randint(0, 200, (REF_SLOTS * rc, wc)).astype(dt)
    Y = rng.randint(0, 256, (cfg.H, cfg.W)).astype(np.int32)
    Cb = rng.randint(0, 256, (Hc, Wc)).astype(np.int32)
    Cr = rng.randint(0, 256, (Hc, Wc)).astype(np.int32)
    slot = 5
    ty, tc = jax.jit(update_tables, static_argnames=("cfg",))(
        jnp.asarray(ty0), jnp.asarray(tc0), jnp.asarray(Y), jnp.asarray(Cb),
        jnp.asarray(Cr), np.int32(slot), cfg=cfg)
    ty, tc = np.asarray(ty), np.asarray(tc)
    if cfg.chroma_fmt == 1:
        ny, nc = (np.asarray(a) for a in build_tables(
            Y[None], Cb[None], Cr[None], bitdepth=cfg.bitdepth))
        np.testing.assert_array_equal(tc[slot * rc:(slot + 1) * rc], nc)
    else:
        ny = np.asarray(build_tile_table_y(
            np.pad(Y, PAD_Y, mode="edge")[None].astype(np.int16), dt))
        np.testing.assert_array_equal(tc, tc0)
    np.testing.assert_array_equal(ty[slot * ry:(slot + 1) * ry], ny)
    keep = np.ones(REF_SLOTS, bool)
    keep[slot] = False
    np.testing.assert_array_equal(
        ty.reshape(REF_SLOTS, ry, wy)[keep],
        ty0.reshape(REF_SLOTS, ry, wy)[keep])
    if cfg.chroma_fmt == 1:
        np.testing.assert_array_equal(
            tc.reshape(REF_SLOTS, rc, wc)[keep],
            tc0.reshape(REF_SLOTS, rc, wc)[keep])


@pytest.mark.parametrize("name", ["p_mv", "p_10bit", "p_wp"])
def test_mc_tap_path_matches_inter_ref(name):
    """The tile-table MC's tap path (no class capacities) against the
    numpy MC oracle on every P frame of real streams: 8-bit, 10-bit and
    weighted prediction, with references from the numpy decode."""
    from libde265_tpu.api import _RefShim, parse_stream_native
    from libde265_tpu.ops import inter_ref
    from libde265_tpu.ops.mc_tile_jax import motion_compensate_frame_tile
    from libde265_tpu.reconstruct import reconstruct_frame
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        plans = parse_stream_native(f.read())
    refs = _RefShim()
    n_checked = 0
    for plan in plans:
        bd = plan.sps.BitDepthY
        if plan.pus:
            shape = [(plan.H, plan.W), (plan.H // 2, plan.W // 2),
                     (plan.H // 2, plan.W // 2)]
            dt = np.uint8 if bd == 8 else np.uint16
            want = [np.zeros(s, dt) for s in shape]
            got = [np.zeros(s, dt) for s in shape]
            inter_ref.motion_compensate_frame(plan, want, refs)
            motion_compensate_frame_tile(plan, got, refs, bd)
            for ci in range(3):
                np.testing.assert_array_equal(got[ci], want[ci])
            n_checked += 1
        refs.add(plan.frame_id, plan,
                 reconstruct_frame(plan, dpb_images=refs))
    assert n_checked >= 2
