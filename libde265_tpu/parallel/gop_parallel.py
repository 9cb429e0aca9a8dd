"""GOP-level parallel decode: split an Annex-B stream at IRAP boundaries and
decode the segments concurrently.

This is the scaling axis from SURVEY §5: random-access points
(IDR/BLA/CRA) are natural checkpoint/shard boundaries — each GOP is fully
self-contained (the reference leaves frame-level parallelism as a TODO,
decctx.cc:904-910). backend "device" shards GOPs over a device mesh;
backend "numpy" decodes them in host worker processes (tools/bench_gop.py).
"""
import multiprocessing as mp
import os

from ..bitstream.nal import is_idr, is_bla, is_cra, is_vcl


def split_gops(stream: bytes):
    """Split an Annex-B stream into self-contained segments, each starting
    with the parameter sets + one IRAP. Returns list of byte strings."""
    # find start-code positions + nal types
    units = []
    i = 0
    n = len(stream)
    while True:
        j = stream.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        start = j - 1 if j > 0 and stream[j - 1] == 0 else j
        k = stream.find(b"\x00\x00\x01", j + 3)
        end = n if k < 0 else (k - 1 if stream[k - 1] == 0 else k)
        t = (stream[j + 3] >> 1) & 0x3F
        units.append((t, start, end))
        i = j + 3
    # parameter sets prefix
    ps = b"".join(stream[s:e] for (t, s, e) in units if t in (32, 33, 34))
    gops = []
    cur = bytearray()
    for (t, s, e) in units:
        if t in (32, 33, 34):
            continue
        if is_vcl(t) and (is_idr(t) or is_bla(t) or is_cra(t)):
            if cur:
                gops.append(bytes(cur))
            cur = bytearray()
        cur += stream[s:e]
    if cur:
        gops.append(bytes(cur))
    return [ps + g for g in gops]


def _decode_gop(args):
    idx, seg, native = args
    if native:
        from ..api import decode_stream_native as ds
    else:
        from ..api import decode_stream as ds
    pics = ds(seg)
    return idx, [(p.poc, p.to_yuv_bytes()) for p in pics]


def decode_gop_parallel(stream: bytes, workers: int = None,
                        native: bool = True, backend: str = None):
    """Decode GOPs concurrently; returns (poc, yuv_bytes) frames in
    presentation order per GOP.

    backend "device" (the default when JAX has an accelerator): one
    native front-end parse + the GOP-sharded fused device program, one GOP
    per mesh device, zero collectives (parallel/gop_shard.py); its errors
    propagate. backend "numpy": multiprocessing workers each decoding a
    GOP segment on the host."""
    if backend is None:
        import jax
        backend = "device" if jax.default_backend() != "cpu" else "numpy"
    if backend == "device":
        return decode_gop_device(stream)
    if backend != "numpy":
        raise ValueError(f"unknown backend {backend!r}")
    gops = split_gops(stream)
    if len(gops) <= 1:
        return _decode_gop((0, gops[0] if gops else stream, native))[1]
    workers = workers or min(len(gops), mp.cpu_count())
    with mp.Pool(workers) as pool:
        results = pool.map(_decode_gop, [(i, g, native) for i, g in enumerate(gops)])
    results.sort(key=lambda r: r[0])
    out = []
    for _, frames in results:
        out.extend(frames)
    return out


def decode_gop_device(stream: bytes, mesh=None):
    """Native FE parse + GOP-sharded device decode over `mesh` (default:
    a 1-D mesh over every visible device, capped at the GOP count).
    Returns (poc, yuv_bytes) in presentation order per GOP."""
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from ..api import parse_stream_native
    from .gop_shard import decode_gops_sharded, split_gop_plans

    plans = parse_stream_native(stream)
    sps = plans[0].sps
    all_gops = split_gop_plans(plans)
    if mesh is None:
        devs = jax.devices()
        g = min(len(devs), len(all_gops))
        mesh = Mesh(np.array(devs[:g]), ("g",))
    G = mesh.shape["g"]
    dt = np.uint8 if sps.BitDepthY == 8 else np.uint16
    sw, shh = sps.SubWidthC, sps.SubHeightC
    cw = sps.conformance_window_flag
    le = sps.conf_win_left_offset * sw if cw else 0
    r = sps.conf_win_right_offset * sw if cw else 0
    t_ = sps.conf_win_top_offset * shh if cw else 0
    b = sps.conf_win_bottom_offset * shh if cw else 0
    H, W = sps.pic_height_in_luma_samples, sps.pic_width_in_luma_samples
    frames = []
    # more GOPs than devices: run the mesh program in G-sized batches
    # (a pod deployment sizes the mesh to the stream instead)
    for base in range(0, len(all_gops), G):
        batch = [p for g in all_gops[base:base + G] for p in g]
        if len(all_gops) - base < G:        # tail: shrink the mesh
            import jax as _jax
            nb = len(all_gops) - base
            mesh_b = Mesh(np.array(_jax.devices()[:min(
                nb, len(_jax.devices()))]), ("g",))
        else:
            mesh_b = mesh
        out, where, gops = decode_gops_sharded(batch, sps, mesh_b,
                                               emit_frames=True)
        fy, fcb, fcr = (np.asarray(out[5]), np.asarray(out[6]),
                        np.asarray(out[7]))
        for gi, g in enumerate(gops):
            order = sorted(range(len(g)), key=lambda i: g[i].poc)
            for i in order:
                y = fy[gi, i, t_:H - b, le:W - r].astype(dt)
                cb = fcb[gi, i, t_ // shh:(H - b) // shh,
                         le // sw:(W - r) // sw].astype(dt)
                cr = fcr[gi, i, t_ // shh:(H - b) // shh,
                         le // sw:(W - r) // sw].astype(dt)
                frames.append((g[i].poc,
                               y.tobytes() + cb.tobytes() + cr.tobytes()))
    return frames
