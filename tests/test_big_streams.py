"""Realistic-size golden vectors: 720p/1080p WPP, 4x4 tile grid, big MVs.

Covers the scale gap vs the reference's conformance coverage
(/root/reference/README.md:11-13): multi-CTB-row WPP context inheritance,
large tile grids and long-distance MC, bit-exact vs the reference decoder.
Uses the native front-end (the production parse path)."""
import json
import os

import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")


def _case(name):
    with open(os.path.join(DATA, "manifest_big.json")) as f:
        m = json.load(f)[name]
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return m, f.read()


@pytest.mark.slow
@pytest.mark.parametrize("name", ["ld_720p_wpp", "ld_1080p_wpp",
                                  "tiles44_1080p", "bigmv_720p",
                                  "intra_720p", "ld1080p_light_wppb",
                                  "ld4k_light_wppb"])
def test_big_stream_native(name):
    from libde265_tpu.api import decode_stream_native
    m, data = _case(name)
    pics = decode_stream_native(data)
    assert len(pics) == m["frames"]
    for i, pic in enumerate(pics):
        got = [pic.plane_md5(c) for c in range(3)]
        want = [m["md5"][i][k] for k in ("y", "u", "v")]
        assert got == want, f"{name} frame {i}"


@pytest.mark.slow
def test_mixedmv_device_general_sort_path():
    """720p stream whose per-CU qpel MVs cover every (phase, alignment)
    class: the class-masked matmul MC takes the full general path
    inside the fused device program; must be bit-exact vs dec265."""
    from libde265_tpu.api import decode_stream_native
    m, data = _case("mixedmv_720p")
    pics = decode_stream_native(data, backend="device")
    assert len(pics) == m["frames"]
    for i, pic in enumerate(pics):
        got = [pic.plane_md5(c) for c in range(3)]
        want = [m["md5"][i][k] for k in ("y", "u", "v")]
        assert got == want, f"mixedmv_720p frame {i}"


@pytest.mark.slow
@pytest.mark.parametrize("name", ["ld1080p_light", "ld720p_light"])
def test_bench_stream_device_odd_lattice(name):
    """1080p/720p bench streams through the FUSED device program:
    1080 is not a 16-multiple, exercising the ceil-lattice residual
    scatter, padded intra wavefront lattice, and padded chroma deblock
    phases."""
    from libde265_tpu.api import decode_stream_native
    m, data = _case(name)
    pics = decode_stream_native(data, backend="device")
    assert len(pics) == m["frames"]
    for i, pic in enumerate(pics):
        got = [pic.plane_md5(c) for c in range(3)]
        want = [m["md5"][i][k] for k in ("y", "u", "v")]
        assert got == want, f"{name} frame {i}"
