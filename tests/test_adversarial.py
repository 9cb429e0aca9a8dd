"""Adversarial encoder-knob cross-product vectors (manifest_adv.json,
tools/gen_adversarial_streams.py): feature
COMBINATIONS the per-feature goldens never exercise together (WPP x
dependent slices x 10-bit x scaling lists, tiles x lossless x qp-delta,
B x weighted x long-term refs, rext formats x tiles/tskip/SDH). Each
must decode bit-exact vs dec265 through the production native-FE +
device-stream path."""
import hashlib
import json
import os

import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")


def _cases():
    p = os.path.join(DATA, "manifest_adv.json")
    if not os.path.exists(p):
        return []
    return sorted(json.load(open(p)).keys())


@pytest.mark.parametrize("name", _cases() or ["_absent_"])
def test_adversarial_stream_golden(name):
    if name == "_absent_":
        pytest.skip("manifest_adv.json not generated")
    from tests.test_intra_fused import _parse
    from libde265_tpu.device_stream import DeviceStreamDecoder
    man = json.load(open(os.path.join(DATA, "manifest_adv.json")))[name]
    plans = _parse(os.path.join(DATA, name + ".bin"))
    assert len(plans) == man["frames"]
    dec = DeviceStreamDecoder(plans, plans[0].sps)
    dec.decode_all()
    for i, p in enumerate(plans):
        planes = dec.planes_of(p.frame_id)
        keys = [k for k in "yuv" if k in man["md5"][i]]
        got = [hashlib.md5(planes[c].tobytes()).hexdigest()
               for c in range(len(keys))]
        want = [man["md5"][i][k] for k in keys]
        assert got == want, f"{name} frame {i} (poc {p.poc})"
