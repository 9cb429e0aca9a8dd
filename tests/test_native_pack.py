"""Native (C++) plan packing: fe_pack_frame must produce BYTE-IDENTICAL
per-dtype blob buffers to the numpy pack_frame+pack_blob path for every
supported stream shape. Reference analog: the decoder packs nothing — it
decodes in place (slice.cc:4664-4830); this stage exists only for the
device path, so the numpy path is its oracle."""
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
    ("manifest_big.json", "ld4k_light"),
    ("manifest_big.json", "gop1080p"),
    ("manifest_inter.json", "p_mixed"),
    ("manifest_inter.json", "b_mixed"),
    ("manifest_inter.json", "p_tiles4_mv"),
    ("manifest_inter.json", "p_slices2wpp"),
    ("manifest_inter.json", "p_tskip"),
    ("manifest_inter.json", "p_qpdelta"),
    ("manifest_inter.json", "p_sdh"),
    ("manifest_inter.json", "b_mv"),
    ("manifest_inter.json", "b_mvdl1zero"),
    ("manifest_inter.json", "b_reflist_mod"),
    ("manifest_inter.json", "p_2ref"),
    ("manifest_inter.json", "p_bigmv"),
    ("manifest_inter.json", "p_tmvp"),
    ("manifest_inter.json", "p_depslices"),
    ("manifest_inter.json", "p_tqbypass"),
    ("manifest_inter.json", "p_2pu_amp"),
    ("manifest_inter.json", "p_ttsplit"),
    ("manifest_inter.json", "p_temporal"),
    ("manifest_inter.json", "p_ltr"),
])
def test_native_pack_matches_numpy(mf, name):
    from dataclasses import replace
    from libde265_tpu.frame_program import (stream_cfg, pack_frame,
                                            frame_compatible,
                                            frame_has_intra, REF_SLOTS,
                                            blob_meta, pack_blob,
                                            pack_blob_native)
    path = os.path.join(DATA, name + ".bin")
    if not os.path.exists(path):
        pytest.skip(name + " absent")
    plans = _parse(path)
    frames = [p for p in plans if p.nal_type != -1
              and frame_compatible(p)]
    pframes = [p for p in frames if not frame_has_intra(p)]
    if not pframes:
        pytest.skip("no pure-inter frames")
    cfg = stream_cfg(plans, plans[0].sps)
    cfg_p = replace(cfg, intra=(), intra_C=0)
    fid_slot = {p.frame_id: i % REF_SLOTS for i, p in enumerate(frames)}
    pk = [pack_frame(p, cfg_p, fid_slot, real_slots=True)
          for p in pframes]
    stacked = {k: np.stack([t[k] for t in pk]) for k in pk[0]}
    meta, totals = blob_meta(stacked)
    want = pack_blob(stacked, meta, totals)
    got = pack_blob_native(pframes, cfg_p, fid_slot, meta, totals)
    if got is None:
        pytest.skip("layout outside native writer set (fallback ok)")
    assert set(got) == set(want)
    for dt in want:
        if not np.array_equal(got[dt], want[dt]):
            # locate the first differing key for the failure message
            for (k, d, shape, off) in meta:
                if d != dt:
                    continue
                n = int(np.prod(shape))
                a, b = got[dt][off:off + n], want[dt][off:off + n]
                assert np.array_equal(a, b), \
                    (name, k, dt, int((a != b).sum()))
            assert False, (name, dt)
