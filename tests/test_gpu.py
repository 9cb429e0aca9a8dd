"""Tests that need an NVIDIA GPU (marker `gpu`; they skip elsewhere).

Run on the card with:  JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import json
import os

import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.mark.gpu
@pytest.mark.parametrize("mf,name", [("manifest_inter.json", "p_mv"),
                                     ("manifest_rext.json",
                                      "rext_444_inter_12b")])
def test_fused_decode_on_gpu(gpu, mf, name):
    """decode_stream_native(backend="device") on the card: every frame
    fused, every plane MD5-exact."""
    from libde265_tpu.api import decode_stream_native
    with open(os.path.join(DATA, mf)) as f:
        man = json.load(f)[name]
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        pics = decode_stream_native(f.read(), backend="device")
    assert [p.route for p in pics] == ["fused"] * man["frames"]
    for i, pic in enumerate(pics):
        mono = pic.chroma_format == 0
        keys = ("y",) if mono else ("y", "u", "v")
        got = [pic.plane_md5(c) for c in range(len(keys))]
        assert got == [man["md5"][i][k] for k in keys], (name, i)
