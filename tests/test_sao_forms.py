"""The device SAO (plan_sao_device + sao_apply) against the numpy
reference (ops/sao_ref.py): on every frame of real SAO streams, and per
SAO type and edge class, with every CTB of a real frame forced to one
band or edge class with random offsets, over random planes."""
import os

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")


def _plans(name):
    from libde265_tpu.api import parse_stream_native
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return parse_stream_native(f.read())


def _random_planes(plan, rng):
    sps = plan.sps
    bd = sps.BitDepthY
    dt = np.uint8 if bd == 8 else np.uint16
    shapes = [(plan.H, plan.W)]
    if sps.ChromaArrayType:
        shapes += [(plan.H // sps.SubHeightC, plan.W // sps.SubWidthC)] * 2
    else:
        shapes += [(0, 0)] * 2
    return [rng.randint(0, 1 << bd, s).astype(dt) for s in shapes]


def _device_sao(plan, cfg, planes):
    """The fused program's SAO stage (frame_program.sao_planes)."""
    import jax.numpy as jnp
    from libde265_tpu import frame_program as fp
    t = {k: jnp.asarray(v) for k, v in fp.filter_grids(plan, cfg).items()}
    out = fp.sao_planes(*(jnp.asarray(p.astype(np.int32)) for p in planes),
                        t, cfg)
    return [np.asarray(p) for p in out[:1 if cfg.mono else 3]]


@pytest.mark.parametrize("name", ["p_sao", "i_deblk_sao", "p_filters",
                                  "rext_422_filters", "rext_444_filters"])
def test_sao_apply_matches_sao_ref(name):
    from libde265_tpu.frame_program import stream_cfg
    from libde265_tpu.ops.sao_ref import sao_frame
    plans = _plans(name)
    cfg = stream_cfg(plans, plans[0].sps)
    rng = np.random.RandomState(1)
    n_on = 0
    for plan in plans:
        planes = _random_planes(plan, rng)
        want = sao_frame(plan, planes)
        got = _device_sao(plan, cfg, planes)
        for ci, g in enumerate(got):
            np.testing.assert_array_equal(g, want[ci])
        n_on += int(plan.sao.type_idx.any())
    assert n_on, "stream has no SAO CTB"


@pytest.mark.parametrize("mode", ["band", "eo0", "eo1", "eo2", "eo3"])
@pytest.mark.parametrize("name", ["p_tiles22", "adv_wpp_dep10_scaling"])
def test_sao_apply_per_class_matches_sao_ref(name, mode):
    from libde265_tpu.frame_program import stream_cfg
    from libde265_tpu.ops.sao_ref import sao_frame
    plans = _plans(name)
    plan = plans[-1]
    cfg = stream_cfg(plans, plans[0].sps)
    rng = np.random.RandomState(sum(map(ord, name + mode)))
    sao = plan.sao
    sao.type_idx[:] = 1 if mode == "band" else 2
    sao.eo_class[:] = 0 if mode == "band" else int(mode[-1])
    sao.band_pos[:] = rng.randint(0, 32, sao.band_pos.shape)
    lim = 7 << (cfg.bitdepth - min(cfg.bitdepth, 10))
    offs = rng.randint(-lim, lim + 1, sao.offsets.shape)
    if mode != "band":          # edge offsets: + for valleys, - for peaks
        offs[..., :2] = np.abs(offs[..., :2])
        offs[..., 2:] = -np.abs(offs[..., 2:])
    sao.offsets[:] = offs
    for sh in plan.slice_headers:
        sh.slice_sao_luma_flag = sh.slice_sao_chroma_flag = 1
    planes = _random_planes(plan, rng)
    want = sao_frame(plan, planes)
    assert (want[0] != planes[0]).mean() > 0.05, "SAO left the plane as is"
    got = _device_sao(plan, cfg, planes)
    for ci, g in enumerate(got):
        np.testing.assert_array_equal(g, want[ci])
