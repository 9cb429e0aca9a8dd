#!/usr/bin/env python3
"""Smoke test of the fused device decode on an NVIDIA GPU.

    python chip_smoke.py               # one card: phases 1-6
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

Phases (one line each before the result):
  1. device    nvidia-smi name and power limit, jax.devices(), XLA_FLAGS
  2. frontend  rebuild native/libhevc_frontend.so from source
  3. 4K        ld4k_light (33 frames) and ld4k (9) through
               decode_stream_native(backend="device"): every plane MD5
               against tests/data/manifest_big.json, no numpy-route frame
  4. intra     gop1080p (96 frames, 16 IDRs), checked the same way
  5. formats   10/12-bit, 4:2:2, 4:4:4, mono, PCM, scaling-list streams
  6. kernels   stage outputs at 4K shapes against the numpy references
               (tolerance 0), memory_analysis() of the P-frame program
  7. sharded   (--four-cards: phases 1, 2 and this one only) GOP-sharded
               gop1080p and tile-sharded tiles44_1080p over four cards,
               against the manifest and a one-card decode in the same
               process

Fails (non-zero exit, no result line) when JAX finds no GPU, when the
repository is not beside it, or when any phase fails. The last line of
stdout is {"ok": true, "device": {"platform", "kind", "count"}}.
"""
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "tests", "data")
FORMAT_STREAMS = (
    ("manifest_inter.json", "p_10bit"),              # 10-bit 4:2:0
    ("manifest_rext.json", "rext_420_inter_12b"),    # 12-bit 4:2:0
    ("manifest_rext.json", "rext_422_inter"),        # 4:2:2
    ("manifest_rext.json", "rext_444_inter"),        # 4:4:4
    ("manifest_rext.json", "rext_444_inter_12b"),    # 4:4:4 12-bit
    ("manifest_rext.json", "rext_mono_inter"),       # monochrome
    ("manifest_inter.json", "p_pcm"),                # PCM 4:2:0
    ("manifest_rext.json", "rext_422_pcm"),          # PCM 4:2:2
    ("manifest_inter.json", "p_scaling"),            # scaling lists
    ("manifest_adv.json", "adv_cra_scaling_10b_amp"),  # scaling, 10-bit
)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def manifest(name, stream):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)[stream]


def read_stream(stream):
    with open(os.path.join(DATA, stream + ".bin"), "rb") as f:
        return f.read()


def frame_md5s(planes, mono):
    return [hashlib.md5(p.tobytes()).hexdigest()
            for p in (planes[:1] if mono else planes)]


def want_md5s(entry, mono):
    return [entry[k] for k in (("y",) if mono else ("y", "u", "v"))]


def decode_checked(mname, stream):
    """decode_stream_native(backend="device") with every plane MD5 and
    every frame's route checked. Returns (pictures, route counts, s)."""
    from libde265_tpu.api import decode_stream_native
    man = manifest(mname, stream)
    data = read_stream(stream)
    t0 = time.perf_counter()
    pics = decode_stream_native(data, backend="device")
    dt = time.perf_counter() - t0
    assert len(pics) == man["frames"], (stream, len(pics), man["frames"])
    routes = {}
    for i, pic in enumerate(pics):
        mono = pic.chroma_format == 0
        got = frame_md5s(pic.planes, mono)
        assert got == want_md5s(man["md5"][i], mono), \
            f"{stream} frame {i} (poc {pic.poc}): MD5 mismatch"
        routes[pic.route] = routes.get(pic.route, 0) + 1
    assert not routes.get("numpy"), f"{stream}: numpy-route frames {routes}"
    return pics, routes, dt


def parse_plans(stream):
    from libde265_tpu.api import parse_stream_native
    return parse_stream_native(read_stream(stream))


def warm_ms_per_frame(stream):
    """Second decode of an already compiled stream: parse excluded, pack +
    upload + device included, ended by block_until_ready."""
    import jax
    from libde265_tpu.device_stream import DeviceStreamDecoder
    plans = parse_plans(stream)
    dec = DeviceStreamDecoder(plans, plans[0].sps)
    t0 = time.perf_counter()
    dec.decode_all()
    jax.block_until_ready((dec.dy, dec.dcb, dec.dcr))
    return (time.perf_counter() - t0) * 1000.0 / len(plans), dec, plans


# ------------------------------------------------------------- phases
def phase_device(four):
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"JAX finds no GPU (default backend {backend!r})")
    need = 4 if four else 1
    if len(jax.devices()) < need:
        raise RuntimeError(f"{need} GPUs needed, JAX sees {jax.devices()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    for line in smi.splitlines():
        say("device", f"nvidia-smi: {line.strip()}")
    say("device", f"jax {jax.__version__} devices {jax.devices()} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")


def phase_frontend():
    t0 = time.perf_counter()
    r = subprocess.run(["make", "-C", os.path.join(REPO, "native"), "-B"],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"front-end build failed:\n{r.stdout}{r.stderr}")
    so = os.path.join(REPO, "native", "libhevc_frontend.so")
    say("frontend", f"rebuilt {os.path.relpath(so, REPO)} from "
        f"native/frontend.cc in {time.perf_counter() - t0:.1f}s "
        f"({os.path.getsize(so)} bytes)")


def phase_decode(tag, streams):
    out = {}
    for stream in streams:
        pics, routes, cold = decode_checked("manifest_big.json", stream)
        ms, dec, plans = warm_ms_per_frame(stream)
        say(tag, f"{stream}: {len(pics)} frames MD5-exact, routes {routes}, "
            f"first call {cold:.1f}s (parse + compile + decode + download), "
            f"warm {ms:.2f} ms/frame (pack + upload + device)")
        out[stream] = (dec, plans)
    return out


def phase_formats():
    done = []
    for mname, stream in FORMAT_STREAMS:
        pics, routes, _ = decode_checked(mname, stream)
        assert set(routes) == {"fused"}, f"{stream}: routes {routes}"
        done.append(f"{stream}({len(pics)})")
    say("formats", f"{len(done)} streams MD5-exact, every frame fused: "
        + " ".join(done))


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    n = int((a.astype(np.int64) != b.astype(np.int64)).sum())
    assert n == 0, f"{what}: {n} samples differ"


def phase_kernels(dec, plans):
    """Each device stage that stays, against its numpy reference, on the
    first P frame (and the IDR for residuals) of ld4k_light."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from libde265_tpu import frame_program as fp
    from libde265_tpu.device_stream import _HostRefShim
    from libde265_tpu.ops import inter_ref, transform_ref, transform_jax
    from libde265_tpu.ops.deblock_ref import deblock_frame
    from libde265_tpu.ops.mc_tile_jax import motion_compensate_frame_tile
    from libde265_tpu.ops.sao_ref import sao_frame

    cfg = dataclasses.replace(dec.cfg, intra=(), intra_C=0)
    idr, pf = plans[0], plans[1]
    bd = cfg.bitdepth
    refs = _HostRefShim(dec)

    # (first: reading plan.tus / plan.pus below releases the packed arrays)
    prog = fp.get_program(cfg)
    fid_slot = {f: i % fp.REF_SLOTS for i, f in enumerate(dec.frames)}
    td = {k: jnp.asarray(v) for k, v in
          fp.pack_frame(pf, cfg, fid_slot, real_slots=True).items()}
    ma = prog.lower(dec.dy, dec.dcb, dec.dcr, dec.ty, dec.tc, td,
                    np.int32(0)).compile().memory_analysis()
    say("kernels", f"P-frame program memory_analysis: {ma}")

    # luma + chroma MC: class-masked matmul path and the tap path
    want = [np.zeros_like(p) for p in dec.planes_of(pf.frame_id)]
    inter_ref.motion_compensate_frame(pf, want, refs)
    for caps in ((cfg.mc_caps, cfg.mc_caps_c), (None, None)):
        got = [np.zeros_like(p) for p in want]
        motion_compensate_frame_tile(pf, got, refs, bd, *caps)
        for ci in range(3):
            _same(got[ci], want[ci], f"MC plane {ci} caps={bool(caps[0])}")
    say("kernels", f"MC (class-masked matmul and tap path) == inter_ref "
        f"on {pf.W}x{pf.H}, {len(pf.pus)} PUs")

    # residual transforms, per (plane, size, DST) batch, IDR + P frame
    n_tu = 0
    for plan in (idr, pf):
        groups = {}
        for tu in plan.tus:
            if tu.cidx < 0 or tu.coeffs is None or tu.transform_skip \
                    or tu.tq_bypass:
                continue
            dst = tu.cidx == 0 and tu.log2 == 2 and \
                tu.pred_mode == fp.MODE_INTRA
            groups.setdefault((tu.log2, dst), []).append(tu)
        for (log2, dst), tus in groups.items():
            c = np.stack([tu.coeffs for tu in tus]).astype(np.int32)
            q = np.asarray([tu.qp for tu in tus], np.int32)
            got = transform_jax.residual_batch(jnp.asarray(c),
                                               jnp.asarray(q), log2, dst, bd)
            want = np.stack([transform_ref.scale_and_inv_transform(
                tu.coeffs, tu.qp, log2, dst, False, False, bd)
                for tu in tus])
            _same(got, want, f"residual log2={log2} dst={dst}")
            n_tu += len(tus)
    say("kernels", f"residual transforms == transform_ref on {n_tu} TUs "
        f"(IDR + first P frame)")

    # deblock and SAO from the same host grids the fused program uses
    t = {k: jnp.asarray(v) for k, v in fp.filter_grids(pf, cfg).items()}
    src = [np.asarray(p) for p in dec.planes_of(pf.frame_id)]
    dev_in = [jnp.asarray(p.astype(np.int32)) for p in src]
    want = [p.copy() for p in src]
    deblock_frame(pf, want)
    dbk = jax.jit(fp.deblock_planes, static_argnames=("cfg",))
    got = dbk(*dev_in, t, cfg=cfg)
    for ci in range(3):
        _same(got[ci], want[ci], f"deblock plane {ci}")
    say("kernels", "deblock == deblock_ref")

    want = sao_frame(pf, src)
    sao = jax.jit(fp.sao_planes, static_argnames=("cfg",))
    got = sao(*dev_in, t, cfg=cfg)
    for ci in range(3):
        _same(got[ci], want[ci], f"SAO plane {ci}")
    say("kernels", "SAO == sao_ref")



def phase_sharded():
    """GOP- and tile-sharded decode over four cards, against the manifest
    and a one-card decode of the same stream in this process."""
    import jax
    from jax.sharding import Mesh
    from libde265_tpu.device_stream import (DeviceStreamDecoder,
                                            ShardedStreamDecoder)
    from libde265_tpu.parallel.gop_parallel import decode_gop_device
    devs = jax.devices()[:4]

    man = manifest("manifest_big.json", "gop1080p")
    data = read_stream("gop1080p")
    t0 = time.perf_counter()
    frames = decode_gop_device(data, Mesh(np.array(devs), ("g",)))
    dt = time.perf_counter() - t0
    assert len(frames) == man["frames"], len(frames)
    one, _, _ = decode_checked("manifest_big.json", "gop1080p")
    for i, ((poc, yuv), pic) in enumerate(zip(frames, one)):
        assert poc == pic.poc, (i, poc, pic.poc)
        assert yuv == pic.to_yuv_bytes(), f"gop1080p frame {i} != one card"
        n = [p.size * p.itemsize for p in pic.planes]
        got = [hashlib.md5(yuv[a:a + b]).hexdigest()
               for a, b in ((0, n[0]), (n[0], n[1]), (n[0] + n[1], n[2]))]
        assert got == want_md5s(man["md5"][i], False), f"gop1080p frame {i}"
    say("sharded", f"gop1080p GOP-sharded over {len(devs)} cards: "
        f"{len(frames)} frames == manifest == one-card decode "
        f"({dt:.1f}s incl. compile)")

    man = manifest("manifest_big.json", "tiles44_1080p")
    plans = parse_plans("tiles44_1080p")
    sh = ShardedStreamDecoder(plans, plans[0].sps,
                              Mesh(np.array(devs), ("t",)))
    for i, plan in enumerate(plans):
        sh.decode_plan(plan, i)
    plans1 = parse_plans("tiles44_1080p")
    one = DeviceStreamDecoder(plans1, plans1[0].sps)
    one.decode_all()
    for i, (p, p1) in enumerate(zip(plans, plans1)):
        got = sh.planes_of(p.frame_id)
        ref = one.planes_of(p1.frame_id)
        for ci in range(3):
            _same(got[ci], ref[ci], f"tiles44_1080p frame {i} plane {ci}")
        assert frame_md5s(got, False) == want_md5s(man["md5"][i], False), \
            f"tiles44_1080p frame {i}"
    say("sharded", f"tiles44_1080p tile-sharded over {len(devs)} cards: "
        f"{len(plans)} frames == manifest == one-card decode, routes "
        f"{sh.route_counts()}")


def main():
    four = "--four-cards" in sys.argv[1:]
    if not os.path.isdir(os.path.join(REPO, "libde265_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from libde265_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    phase_device(four)
    phase_frontend()
    if four:
        phase_sharded()
    else:
        dec4k = phase_decode("4K", ("ld4k_light", "ld4k"))
        phase_decode("intra", ("gop1080p",))
        phase_formats()
        phase_kernels(*dec4k["ld4k_light"])
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
