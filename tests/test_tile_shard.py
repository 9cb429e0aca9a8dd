"""Multi-chip tile-column decode: the shard_map program (one device per
tile column, replicated DPB, halo-exchanged loop filters) must be
bit-exact vs the reference decoder's golden MD5s on the virtual CPU
mesh. Covers loop-filter-across-tiles on AND off, 2- and 4-column grids,
and verifies the sharded fast path actually ran (not the hybrid
fallback)."""
import json
import os

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")


def _decode_sharded(name, ndev):
    import jax
    from jax.sharding import Mesh
    from libde265_tpu.native_frontend import NativeFrontend
    from libde265_tpu.bitstream.nal import split_annexb
    from libde265_tpu.bitstream.paramsets import read_sps, read_pps
    from libde265_tpu.device_stream import ShardedStreamDecoder

    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
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
    plans = NativeFrontend().parse(data, spss, ppss)
    devs = jax.devices()[:ndev]
    assert len(devs) == ndev, "conftest provides an 8-device CPU mesh"
    mesh = Mesh(np.array(devs), ("t",))
    dec = ShardedStreamDecoder(plans, plans[0].sps, mesh)
    n_fast = 0
    for i, plan in enumerate(plans):
        dec.decode_plan(plan, i)
        if dec.frames[plan.frame_id]["route"] == "fused":
            n_fast += 1
    return plans, dec, n_fast


@pytest.mark.parametrize("name,ndev", [
    ("p_tiles2_mv", 2),
    ("p_tiles2_mv_nolf", 2),
    ("p_tiles4_mv", 4),
    ("p_tiles8_mv", 8),
    # NON-uniform column widths + a uniform-spacing grid whose ceil
    # distribution yields unequal columns (pps.h:109-151 colBd):
    # strips pad to the widest column, reassembly is width-aware
    ("p_tiles8nu_mv", 8),
    ("p_tiles3r_mv", 3),
])
def test_sharded_tiles_golden(name, ndev):
    if not os.path.exists(os.path.join(DATA, name + ".bin")):
        pytest.skip(name + " vector absent")
    with open(os.path.join(DATA, "manifest_inter.json")) as f:
        man = json.load(f)
    m = man[name]
    plans, dec, n_fast = _decode_sharded(name, ndev)
    assert n_fast >= len(plans) - 1, \
        f"sharded fast path ran only {n_fast}/{len(plans)} frames"
    import hashlib
    outs = sorted((p for p in plans if p.output_flag), key=lambda p: p.poc)
    assert len(outs) == m["frames"]
    for i, plan in enumerate(outs):
        planes = dec.planes_of(plan.frame_id)
        got = [hashlib.md5(np.ascontiguousarray(pl).tobytes()).hexdigest()
               for pl in planes]
        want = [m["md5"][i][k] for k in ("y", "u", "v")]
        assert got == want, f"{name} frame {i} (poc {plan.poc})"
