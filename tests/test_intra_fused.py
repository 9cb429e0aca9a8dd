"""Fused-path intra reconstruction (intra_fused.py): intra-containing
frames must decode THROUGH the fused frame program (not the hybrid
fallback) and stay bit-exact vs the dec265 golden MD5s.

Reference capability mirrored: inline intra decode in the CTB loop
(/root/reference/libde265/intrapred.cc:1074-1164, slice.cc:3424-3488).
"""
import json
import hashlib
import os

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")

# (manifest, stream): intra-only, strong-smoothing 32x32, CIP, and
# mixed P-with-intra coverage
CASES = [
    ("manifest.json", "intra_cif_q30"),
    ("manifest.json", "intra_cif_q20_nxn"),
    ("manifest.json", "intra_cif_maxcb64"),
    ("manifest.json", "intra_104x72_q26"),
    ("manifest_inter.json", "i_deblk_sao"),
    ("manifest_inter.json", "i_strong32"),
    ("manifest_inter.json", "i_tskip_nxn"),
    ("manifest_inter.json", "p_cip"),
    ("manifest_inter.json", "p_cif_mixed"),
    ("manifest_inter.json", "p_mixed"),
    ("manifest_inter.json", "p_10bit"),
]


def _parse(path):
    from libde265_tpu.native_frontend import NativeFrontend
    from libde265_tpu.bitstream.nal import split_annexb
    from libde265_tpu.bitstream.paramsets import read_sps, read_pps
    with open(path, "rb") as f:
        data = f.read()
    spss, ppss = {}, {}
    for u in split_annexb(data):
        t = u.header.nal_unit_type
        if t == 33:
            s = read_sps(u.data)
            spss[s.seq_parameter_set_id] = s
        elif t == 34:
            ppss[read_pps(u.data, spss).pic_parameter_set_id] = \
                read_pps(u.data, spss)
    return NativeFrontend().parse(data, spss, ppss)


@pytest.mark.parametrize("mf,name", CASES)
def test_intra_frames_run_fused(mf, name):
    from libde265_tpu.frame_program import (frame_compatible,
                                            frame_has_intra)
    from libde265_tpu.device_stream import DeviceStreamDecoder
    path = os.path.join(DATA, name + ".bin")
    if not os.path.exists(path):
        pytest.skip(name + " vector absent")
    with open(os.path.join(DATA, mf)) as f:
        man = json.load(f)
    m = man[name]
    plans = _parse(path)
    dec = DeviceStreamDecoder(plans, plans[0].sps)
    dec.decode_all()
    n_fused_intra = 0
    for i, p in enumerate(plans):
        planes = dec.planes_of(p.frame_id)
        got = [hashlib.md5(pl.tobytes()).hexdigest() for pl in planes]
        want = [m["md5"][i][k] for k in ("y", "u", "v")]
        assert got == want, f"{name} frame {i} (poc {p.poc})"
        if dec.frames[p.frame_id]["route"] == "fused" and frame_has_intra(p):
            n_fused_intra += 1
    n_eligible = sum(1 for p in plans
                     if frame_compatible(p) and frame_has_intra(p))
    assert n_fused_intra == n_eligible, \
        f"{n_fused_intra}/{n_eligible} intra frames took the fused path"
    assert n_eligible > 0, "case has no fused-eligible intra frame"


def test_intra_caps_cover_every_frame():
    """stream_cfg's intra capacities must admit pack_intra for every
    compatible frame (the asserts inside pack_intra are the check)."""
    from libde265_tpu.frame_program import (stream_cfg, frame_compatible,
                                            frame_has_intra)
    from libde265_tpu.intra_fused import pack_intra
    plans = _parse(os.path.join(DATA, "p_cif_mixed.bin"))
    cfg = stream_cfg(plans, plans[0].sps)
    assert cfg.intra and cfg.intra_C > 0
    for p in plans:
        if frame_compatible(p) and frame_has_intra(p):
            t = pack_intra(p, cfg)
            for (pl, log2, Ktot, Klvl, E, kinds) in cfg.intra:
                off = t[f"ioff_{pl}_{log2}"]
                assert off.shape == (cfg.intra_C + 1,)
                assert off[-1] + Klvl <= Ktot


@pytest.mark.parametrize("name", ["p_tskip", "p_tqbypass", "p_pcm",
                                  "p_pcm_nolf", "p_scaling", "p_qpdelta",
                                  "i_tskip_nxn", "p_sdh"])
def test_exclusion_streams_run_fused(name):
    """Transform-skip, tq-bypass, PCM and scaling-list
    frames must run the fused device program (no frame_compatible
    exclusion left), bit-exact vs dec265."""
    from libde265_tpu.device_stream import DeviceStreamDecoder
    path = os.path.join(DATA, name + ".bin")
    if not os.path.exists(path):
        pytest.skip(name + " vector absent")
    with open(os.path.join(DATA, "manifest_inter.json")) as f:
        man = json.load(f)
    if name not in man:
        pytest.skip(name + " not in manifest")
    m = man[name]
    plans = _parse(path)
    dec = DeviceStreamDecoder(plans, plans[0].sps)
    dec.decode_all()
    n_fast = 0
    for i, p in enumerate(plans):
        planes = dec.planes_of(p.frame_id)
        got = [hashlib.md5(pl.tobytes()).hexdigest() for pl in planes]
        want = [m["md5"][i][k] for k in ("y", "u", "v")]
        assert got == want, f"{name} frame {i} (poc {p.poc})"
        n_fast += bool(dec.frames[p.frame_id]["route"] == "fused")
    assert n_fast == len(plans), \
        f"{name}: only {n_fast}/{len(plans)} frames took the fused path"


def test_gop1080p_all_frames_fused():
    """The 96-frame 1080p GOP stream (IDR every 32, P with intra refresh)
    must decode ENTIRELY through the fused device program — I-frames via
    the intra wavefront — bit-exact vs dec265. In the default gate
    (~110 s on the CPU backend); the 4K golden decodes run on the GPU in
    chip_smoke.py and bench.py."""
    from libde265_tpu.device_stream import DeviceStreamDecoder
    plans = _parse(os.path.join(DATA, "gop1080p.bin"))
    with open(os.path.join(DATA, "manifest_big.json")) as f:
        m = json.load(f)["gop1080p"]
    dec = DeviceStreamDecoder(plans, plans[0].sps)
    dec.decode_all()
    n_fast = 0
    for i, p in enumerate(plans):
        planes = dec.planes_of(p.frame_id)
        got = [hashlib.md5(pl.tobytes()).hexdigest() for pl in planes]
        want = [m["md5"][i][k] for k in ("y", "u", "v")]
        assert got == want, f"gop1080p frame {i} (poc {p.poc})"
        n_fast += bool(dec.frames[p.frame_id]["route"] == "fused")
    assert n_fast == len(plans), \
        f"only {n_fast}/{len(plans)} frames took the fused path"


def test_fused_intra_matches_hybrid_path():
    """Differential: the fused program output must equal the hybrid
    device path (device_decode.reconstruct_frame_device) pixel-for-pixel
    on an intra frame with every TU size + strong smoothing."""
    from libde265_tpu.device_stream import DeviceStreamDecoder
    from libde265_tpu.device_decode import reconstruct_frame_device
    plans = _parse(os.path.join(DATA, "i_strong32.bin"))
    dec = DeviceStreamDecoder(plans, plans[0].sps)
    dec.decode_all()
    for p in plans:
        fused = dec.planes_of(p.frame_id)
        hybrid = reconstruct_frame_device(p, dpb_images=None,
                                          bitdepth=p.sps.BitDepthY)
        for ci in range(3):
            assert np.array_equal(fused[ci], hybrid[ci]), \
                f"poc {p.poc} plane {ci}"


@pytest.mark.parametrize("mf,name", [
    ("manifest_inter.json", "p_cip"),
    ("manifest_inter.json", "p_tiles8nu_mv"),
    ("manifest_inter.json", "p_slices2wpp"),
    ("manifest.json", "intra_cif_q20_nxn"),
    ("manifest_inter.json", "i_strong32"),
])
def test_border_ok_runs_matches_dense(mf, name):
    """The run-granular availability fast path (_border_ok_runs, the
    round-4 pack-wall fix) must be sample-identical to the per-sample
    oracle across tiles / WPP / CIP / NxN topologies."""
    from libde265_tpu.intra_fused import (assign_levels_meta,
                                          _border_ok_dense, _border_ok)
    plans = _parse(os.path.join(DATA, name + ".bin"))
    checked = 0
    for plan in plans:
        if plan.nal_type == -1 or plan._tu_arrays is None:
            continue
        tm = plan._tu_arrays[0]
        if not tm.shape[0]:
            continue
        levels = assign_levels_meta(plan)
        for log2 in (2, 3, 4, 5):
            for pl in (0, 1):
                sel = ((levels > 0) & (tm[:, 3] == log2)
                       & ((tm[:, 0] == 0) if pl == 0 else (tm[:, 0] > 0)))
                idx = np.flatnonzero(sel)
                if not idx.size:
                    continue
                dense = _border_ok_dense(plan, tm[idx, 1], tm[idx, 2],
                                         tm[idx, 0], log2)
                fast = _border_ok(plan, tm[idx, 1], tm[idx, 2],
                                  tm[idx, 0], log2)
                assert (dense == fast).all(), (name, plan.poc, pl, log2)
                checked += 1
    assert checked
