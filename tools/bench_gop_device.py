#!/usr/bin/env python3
"""GOP-parallel decode on GPUs: the device path.

Three measurements on gop1080p (96 frames, 16 closed GOPs):

1. fe_pipelined_device_fps: the stream decoded on one card through
   decode_all_pipelined (precomputed slot schedule, native C++ pack
   workers, async blob dispatch) — the single-card FE->device pipelined
   rate a multi-card deployment replicates per card. The frames still
   resident at the end are MD5-checked against the dec265 goldens.
2. hlo_collectives: the GOP-sharded shard_map program's lowered HLO is
   searched for collective ops. Zero collectives = frames/s scales
   with cards by construction (only input bits / output frames cross
   the interconnect; the reference leaves frame-parallel decode as a
   TODO, decctx.cc:904-910).
3. mesh_wall_s: weak scaling, n GOPs on an n-card mesh for n = 1, 2, 4
   (as many as the machine has): compile-warm wall time of the sharded
   program (median of three calls), every frame left in a DPB slot
   MD5-checked.
   scaling_efficiency[n] = T(1) / T(n).

Needs a GPU: fails when JAX finds none.

Usage: python tools/bench_gop_device.py [out.json]
"""
import hashlib
import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DATA = os.path.join(REPO, "tests", "data")
STREAM = "gop1080p"


def _parse(name):
    from libde265_tpu.api import parse_stream_native
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return parse_stream_native(f.read())


def _md5s(planes):
    import numpy as np
    return [hashlib.md5(np.ascontiguousarray(pl).astype(np.uint8).tobytes())
            .hexdigest() for pl in planes]


def mesh_wall_s(plans, devs, man):
    """Compile-warm wall time of n GOPs on an n-card mesh (median of three
    calls); every slot's last frame MD5-checked. Returns (seconds, frames
    decoded)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from libde265_tpu.parallel import gop_shard
    mesh = Mesh(np.array(devs), ("g",))
    prog, args, gops = gop_shard._shard_args(plans, plans[0].sps, mesh)
    # inputs laid out as the outputs are, so the timed call reuses the
    # first call's executable
    args = jax.device_put(args, NamedSharding(mesh, P("g")))
    out = jax.block_until_ready(prog(*args))          # compiles
    walls = []
    for _ in range(3):
        t0 = time.time()
        out = jax.block_until_ready(prog(*out[:5], *args[5:]))
        walls.append(time.time() - t0)
    print(f"# {len(devs)}-card mesh: calls {walls} s", file=sys.stderr)
    idx_of = {p.frame_id: i for i, p in enumerate(plans)}
    last = {}
    for fid, (gi, slot, _) in gop_shard.frame_slots(gops).items():
        last[(gi, slot)] = fid
    stacks = [np.asarray(a) for a in out[:3]]
    for (gi, slot), fid in last.items():
        want = [man["md5"][idx_of[fid]][k] for k in ("y", "u", "v")]
        assert _md5s([a[gi, slot] for a in stacks]) == want, (len(devs), gi,
                                                              slot)
    return float(np.median(walls)), sum(len(g) for g in gops)


def main():
    from libde265_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    if jax.default_backend() != "gpu":
        sys.exit(f"bench_gop_device.py needs a GPU; JAX backend is "
                 f"{jax.default_backend()!r}")
    import numpy as np
    from jax.sharding import Mesh
    from libde265_tpu.device_stream import DeviceStreamDecoder
    from libde265_tpu.frame_program import (stream_cfg, pack_frame,
                                            frame_compatible)
    from libde265_tpu.parallel import gop_shard
    with open(os.path.join(DATA, "manifest_big.json")) as f:
        man = json.load(f)[STREAM]

    # ---- 1. one-card FE-pipelined device decode, MD5-verified
    t0 = time.time()
    plans = _parse(STREAM)
    t_parse = time.time() - t0
    nf = len(plans)
    dec = DeviceStreamDecoder(plans, plans[0].sps)
    dec.decode_all_pipelined(keep_outputs=False)         # also compiles
    idx_of = {p.frame_id: i for i, p in enumerate(plans)}
    for fid in sorted(dec.slot_of):
        want = [man["md5"][idx_of[fid]][k] for k in ("y", "u", "v")]
        assert _md5s(dec.planes_of(fid)) == want, fid
    print(f"# verification round: {len(dec.slot_of)} resident frames "
          f"MD5-OK", file=sys.stderr, flush=True)
    times = []
    for r in range(3):
        plans_r = _parse(STREAM)
        dec = DeviceStreamDecoder(plans_r, plans_r[0].sps)
        t0 = time.time()
        dec.decode_all_pipelined(keep_outputs=False)
        dec._host_planes(plans_r[-1].frame_id)     # sync
        times.append(time.time() - t0)
    fps = nf / min(times)
    # upload/link decomposition: plan bytes per frame + a direct link
    # probe, so a low pipelined rate is attributable
    cfgm = stream_cfg(plans, plans[0].sps)
    fid_slot = {p.frame_id: i % 8 for i, p in enumerate(plans)}
    head = plans[:8]
    up_bytes = sum(np.asarray(v).nbytes for p in head if frame_compatible(p)
                   for v in pack_frame(p, cfgm, fid_slot,
                                       real_slots=True).values())
    probe = np.zeros(8 << 20, np.uint8)
    t0 = time.time()
    jax.block_until_ready(jax.device_put(probe))
    link_mbps = probe.nbytes / (time.time() - t0) / 1e6

    # ---- 2. collective census of the GOP-sharded program's HLO
    devs = jax.devices()
    ns = [n for n in (1, 2, 4) if n <= len(devs)]
    lowered = gop_shard.lower_sharded_for_census(
        plans, plans[0].sps, Mesh(np.array(devs[:ns[-1]]), ("g",)))
    n_coll = len(re.findall(
        r"all_reduce|all_gather|all_to_all|collective_permute|"
        r"reduce_scatter", str(lowered.compiler_ir(dialect="stablehlo"))))

    # ---- 3. weak scaling over 1, 2, 4 cards
    walls, frames = {}, {}
    for n in ns:
        walls[n], frames[n] = mesh_wall_s(plans, devs[:n], man)
    d = devs[0]
    out = {
        "stream": STREAM,
        "frames": nf,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(devs)},
        "fe_parse_fps": round(nf / t_parse, 1),
        "fe_pipelined_device_fps": round(fps, 2),
        "upload_mb_per_frame": round(up_bytes / len(head) / 1e6, 2),
        "link_mbps": round(link_mbps, 1),
        "rounds_s": [round(t, 2) for t in times],
        "hlo_collectives": n_coll,
        "mesh_wall_s": {str(n): round(walls[n], 4) for n in ns},
        "mesh_frames": {str(n): frames[n] for n in ns},
        "scaling_efficiency": {str(n): round(walls[1] / walls[n], 3)
                               for n in ns[1:]},
    }
    print(json.dumps(out))
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
