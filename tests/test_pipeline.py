"""Pipelined device stream decode (device_stream.decode_all_pipelined):
pack runs ahead of dispatch on worker threads following a precomputed
slot schedule. Must be bit-exact with the golden MD5s and with the
serial decode_all path.

Reference analog: the dec265 main loop feeding the threaded CTB decoder
(/root/reference/dec265/dec265.cc:681-781)."""
import hashlib
import json
import os

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")


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


@pytest.mark.parametrize("mf,name", [
    ("manifest_inter.json", "p_cif_mixed"),
    ("manifest_inter.json", "p_mixed"),
])
def test_pipelined_matches_golden(mf, name):
    from libde265_tpu.device_stream import DeviceStreamDecoder
    path = os.path.join(DATA, name + ".bin")
    with open(os.path.join(DATA, mf)) as f:
        man = json.load(f)[name]
    plans = _parse(path)
    dec = DeviceStreamDecoder(plans, plans[0].sps)
    dec.decode_all_pipelined(batch=3, pack_workers=2)
    for i, p in enumerate(plans):
        if p.frame_id not in dec.slot_of:
            continue                      # evicted (throughput mode)
        planes = dec.planes_of(p.frame_id)
        got = [hashlib.md5(pl.tobytes()).hexdigest() for pl in planes]
        want = [man["md5"][i][k] for k in ("y", "u", "v")]
        assert got == want, f"{name} frame {i} (poc {p.poc})"
        assert dec.frames[p.frame_id]["route"] == "fused"


def test_pipelined_falls_back_on_hybrid_streams():
    """A stream with any non-fast frame must fall back to decode_all
    and still produce golden output."""
    from libde265_tpu.device_stream import (DeviceStreamDecoder,
                                            PipelineUnsupported)
    # PCM-in-rext runs fused since round 5; cross-component prediction
    # is the remaining per-frame fallback (frame_uses_rext_tools)
    name = "rxt_ccp_444"
    path = os.path.join(DATA, name + ".bin")
    if not os.path.exists(path):
        pytest.skip("rext-tools vector absent")
    with open(os.path.join(DATA, "manifest_rext_tools.json")) as f:
        man = json.load(f)[name]
    plans = _parse(path)
    dec = DeviceStreamDecoder(plans, plans[0].sps)
    with pytest.raises(PipelineUnsupported):
        dec.schedule_slots()
    dec.decode_all_pipelined()            # falls back internally
    planes = dec.planes_of(plans[0].frame_id)
    got = [hashlib.md5(pl.tobytes()).hexdigest() for pl in planes]
    want = [man["md5"][0][k] for k in ("y", "u", "v")]
    assert got == want
