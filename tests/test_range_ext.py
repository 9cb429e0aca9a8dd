"""Chroma-format range extensions (monochrome / 4:2:2 / 4:4:4, intra):
both front-ends must reproduce the reference decoder's golden MD5s
(tests/data/manifest_rext.json, generated by tools/gen_rext_streams.py).

Reference behavior: sps.cc:220-232, slice.cc:3567-3790 (per-format
transform unit incl. the 4:2:2 dual chroma TBs), slice.cc:4240 (4:2:2
intra mode remap), intrapred.cc:1085-1089 (4:4:4 border filtering).
"""
import json
import os

import pytest

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tests", "data")

with open(os.path.join(DATA, "manifest_rext.json")) as f:
    MANIFEST = json.load(f)


def _check(name, pics):
    m = MANIFEST[name]
    assert len(pics) == m["frames"]
    planes = ("y", "u", "v") if m["chroma_format"] else ("y",)
    for i, pic in enumerate(pics):
        for ci, key in enumerate(planes):
            assert pic.plane_md5(ci) == m["md5"][i][key], (name, i, key)


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_native_frontend_golden(name):
    from libde265_tpu.api import decode_stream_native
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        data = f.read()
    _check(name, decode_stream_native(data))


@pytest.mark.parametrize("name", ["rext_422_104x72", "rext_444_104x72",
                                  "rext_mono_104x72", "rext_422_inter",
                                  "rext_444_nxn"])
def test_python_frontend_golden(name):
    """Differential second front-end (slow python CABAC): 8-bit cases."""
    from libde265_tpu.api import decode_stream
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        data = f.read()
    _check(name, decode_stream(data))


def test_mono_picture_has_empty_chroma():
    from libde265_tpu.api import decode_stream_native
    with open(os.path.join(DATA, "rext_mono_104x72.bin"), "rb") as f:
        pics = decode_stream_native(f.read())
    assert pics[0].planes[1].size == 0 and pics[0].planes[2].size == 0
    assert pics[0].planes[0].shape == (72, 104)


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_device_backend_golden(name):
    """decode_stream_native(backend='device') is format-general: the
    device DPB stacks take the format's chroma geometry and every frame
    runs the hybrid device path (device_decode.py) — format-scaled epel
    MC (motion.cc:190-191), per-axis SAO/deblock/wavefront geometry,
    4:4:4 chroma border smoothing (intrapred.cc:1086)."""
    from libde265_tpu.api import decode_stream_native
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        data = f.read()
    _check(name, decode_stream_native(data, backend="device"))


@pytest.mark.parametrize("name", [
    "rext_mono_inter", "rext_422_inter", "rext_444_inter",
    "rext_420_inter_12b", "rext_444_inter_12b", "rext_422_inter_10b",
    "rext_444_inter_10b", "rext_mono_filters", "rext_422_filters",
    "rext_444_filters", "rext_mono_104x72", "rext_422_104x72",
    "rext_444_104x72", "rext_422_10bit", "rext_444_10bit",
    "rext_mono_10bit", "rext_422_nxn", "rext_444_nxn",
])
def test_rext_runs_fused(name):
    """4:2:2 / 4:4:4 / monochrome frames must run
    the FUSED device frame program (frame_compatible no longer excludes
    chroma formats) — dense in-program epel chroma MC, per-axis deblock/
    SAO geometry, per-axis intra availability — bit-exact vs dec265.
    (PCM-in-rext remains the one hybrid fallback: paste layout.)"""
    from libde265_tpu.device_stream import DeviceStreamDecoder
    from tests.test_intra_fused import _parse
    import hashlib
    with open(os.path.join(DATA, "manifest_rext.json")) as f:
        man = json.load(f)[name]
    plans = _parse(os.path.join(DATA, name + ".bin"))
    dec = DeviceStreamDecoder(plans, plans[0].sps)
    dec.decode_all()
    n_fast = 0
    for i, p in enumerate(plans):
        planes = dec.planes_of(p.frame_id)
        mono = plans[0].sps.ChromaArrayType == 0
        got = [hashlib.md5(pl.tobytes()).hexdigest()
               for pl in (planes[:1] if mono else planes)]
        want = [man["md5"][i][k] for k in (("y",) if mono
                                           else ("y", "u", "v"))]
        assert got == want, f"{name} frame {i} (poc {p.poc})"
        n_fast += bool(dec.frames[p.frame_id]["route"] == "fused")
    assert n_fast == len(plans), \
        f"{name}: only {n_fast}/{len(plans)} frames took the fused path"
