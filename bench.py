#!/usr/bin/env python3
"""Benchmark: real 4K HEVC decode on one GPU, MD5-verified.

Decodes tests/data/<stream>.bin (3840x2160 low-delay, IDR + P frames,
mv+residual everywhere, 2 refs, TMVP, deblock+SAO — our encoder, dec265
golden MD5s) through the fused device-resident frame program
(libde265_tpu/frame_program.py): tile-table MC, bucketed residual
transforms, fused intra wavefront (IDR included — nothing is
bootstrapped from the reference decoder), on-device filter planning,
device-resident DPB.

Protocol:
  1. native C++ front-end parses the whole stream (timed: fe_fps)
  2. host packs per-frame plan tensors (timed: pack_fps)
  3. one UNTIMED verification round decodes EVERY frame one by one (IDR
     through the fused intra program, each P frame through the P
     program) and checks every frame's per-plane MD5s against the dec265
     goldens, then runs the P scan program once and checks every slot
     (hard fail on mismatch)
  4. timed rounds re-decode all frames: one blob upload + one dispatch
     for the IDR, one blob upload + one scan dispatch for the P run, all
     chained on the donated DPB carry; block_until_ready at the end.
The headline value is the timed-loop fps (upload + device compute);
fe/pack/device rates are reported alongside — in a pipelined deployment
stages overlap and the achievable rate is the slowest stage.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", "device",
...}; baseline = the reference's published 36 fps 4K software decode
(BASELINE.md). Needs a GPU: fails when JAX finds none.

    python bench.py          # BENCH_STREAM / BENCH_ROUNDS select the cell
"""
import json
import os

import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np

DATA = os.path.join(REPO, "tests", "data")
# headline: realistic-bitrate 4K (the reference's 36 fps is on film
# content at broadcast rates). BENCH_STREAM alternatives: ld4k (the
# ~157 Mbps stress stream), ld4k_mixed (every MC phase/alignment
# class), ld1080p_light / ld720p_light (the reference's 150 / 284 fps
# baseline resolutions).
STREAM = os.environ.get("BENCH_STREAM", "ld4k_light")
ROUNDS = int(os.environ.get("BENCH_ROUNDS", "6"))


def _pipe_worker(wid, nworkers, rounds, stream_path, cfg_i, cfg_p,
                 fid_slot_items, rq, aq, go):
    """Pack-pipeline worker process: parses + packs every `nworkers`-th
    round of the stream and hands the per-dtype blobs to the dispatch
    process through double-buffered SHARED MEMORY (fe_pack_frame writes
    straight into the shm views — measured: a 63 MB round through an
    mp.Queue pipe cost ~3 s, the shm handoff is one 40 ms memcpy on the
    consumer side). A separate PROCESS, not a thread: the host stages
    are numpy/ctypes under the GIL and thread-based overlap regressed
    throughput. This is the shape of the reference's decode thread pool
    (decctx.cc:700-789): host processes feed one device."""
    os.environ["JAX_PLATFORMS"] = "cpu"       # workers never touch the GPU
    os.environ.setdefault("FE_THREADS", "2")  # share 4 cores between 2 workers
    sys.path.insert(0, REPO)
    import numpy as np
    from multiprocessing import shared_memory
    from libde265_tpu.frame_program import (pack_frame, frame_has_intra,
                                            blob_meta, pack_blob,
                                            pack_blob_native)
    with open(stream_path, "rb") as f:
        data = f.read()
    fid_slot = dict(fid_slot_items)
    # warm round: parse+pack with numpy once — this also yields the blob
    # layouts (meta/totals) that size the shm segments
    plans = parse_stream(data)
    meta_cache = {}

    def split(plans_r):
        fr = [p for p in plans_r if p.nal_type != -1]
        return fr, [p for p in fr if frame_has_intra(p)], \
            [p for p in fr if not frame_has_intra(p)]

    def pack_round(plans_r, out=None):
        fr, ifr, pfr = split(plans_r)
        out_blobs = {}
        for kind, pl, cfgu in (("i", ifr, cfg_i), ("p", pfr, cfg_p)):
            dst = out.get(kind) if out else None
            if kind in meta_cache:
                meta, tot = meta_cache[kind]
                nat = pack_blob_native(pl, cfgu, fid_slot, meta, tot,
                                       out=dst)
                if nat is not None:
                    out_blobs[kind] = nat
                    continue
            pk = [pack_frame(p, cfgu, fid_slot, real_slots=True)
                  for p in pl]
            st = {k: np.stack([t[k] for t in pk]) for k in pk[0]}
            meta, tot = blob_meta(st)
            meta_cache[kind] = (meta, tot)
            b = pack_blob(st, meta, tot)
            if dst is not None:
                for dt, a in b.items():
                    dst[dt][:] = a
                out_blobs[kind] = dst
            else:
                out_blobs[kind] = b
        return out_blobs, len(fr)

    first, nf = pack_round(plans)
    del plans        # frees the python plans AND the C++ frames (._fe)

    # two shm buffer sets (ping/pong) sized from the first round
    shms, views, names = [], [], []
    for setid in range(2):
        vs, nm = {}, {}
        for kind, b in first.items():
            vs[kind], nm[kind] = {}, {}
            for dt, a in b.items():
                s = shared_memory.SharedMemory(
                    create=True, size=max(1, a.nbytes))
                v = np.frombuffer(s.buf, dtype=a.dtype, count=a.size)
                if setid == 0:
                    v[:] = a
                shms.append(s)
                vs[kind][dt] = v
                nm[kind][dt] = (s.name, a.dtype.str, a.size)
        views.append(vs)
        names.append(nm)
    rq.put(("ready", wid, names))
    go.wait()
    my_rounds = list(range(wid, rounds, nworkers))
    for j, r in enumerate(my_rounds):
        setid = j % 2
        if j >= 2:
            aq.get()               # main consumed the set two rounds ago
        # EVERY shipped round parses+packs inside the timed window (the
        # warm round above only sizes the shm segments and fills
        # meta_cache) — shipping pre-warmed work would inflate
        # sustained_fps by ~R/(R-nworkers) when pack-bound
        plans_r = parse_stream(data)
        pack_round(plans_r, out=views[setid])
        del plans_r
        rq.put(("blob", nf, (wid, setid)))
    rq.put(("done", wid, None))
    # main acks every blob; drain the tail acks before unlinking
    for _ in range(min(len(my_rounds), 2)):
        aq.get()
    del first
    views.clear()         # release the exported buffer views first
    # the creation-loop locals (vs = last set's view dict, v = last
    # view) still alias exported buffers — the round-4 tail bug's
    # second life; None them before collecting
    vs = nm = v = a = b = None
    import gc
    gc.collect()
    for s in shms:
        try:
            s.close()
        except BufferError:
            pass
        try:
            s.unlink()
        except Exception:
            pass


def parse_stream(data):
    from libde265_tpu.api import parse_stream_native
    return parse_stream_native(data)


def main():
    from libde265_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX backend is "
                 f"{jax.default_backend()!r}")
    import hashlib
    import subprocess
    import jax.numpy as jnp
    from dataclasses import replace
    from libde265_tpu.frame_program import (REF_SLOTS, stream_cfg,
                                            pack_frame, frame_compatible,
                                            frame_has_intra, frame_has_mc,
                                            init_tables, get_program)

    path = os.path.join(DATA, STREAM + ".bin")
    with open(path, "rb") as f:
        data = f.read()
    with open(os.path.join(DATA, "manifest_big.json")) as f:
        man = json.load(f)[STREAM]
    W, H = man["w"], man["h"]

    t0 = time.time()
    plans = parse_stream(data)
    t_parse = time.time() - t0
    nf = len(plans)
    print(f"# parsed {nf} frames in {t_parse:.2f}s "
          f"({nf / t_parse:.1f} fps)", file=sys.stderr)

    cfg = stream_cfg(plans, plans[0].sps)
    frames = [p for p in plans if p.nal_type != -1]
    assert all(frame_compatible(p) for p in frames), "bench stream must " \
        "be fully fused-compatible"
    iframes = [p for p in frames if frame_has_intra(p)]
    pframes = [p for p in frames if not frame_has_intra(p)]
    assert iframes and not any(frame_has_mc(p) for p in iframes), \
        "bench expects pure-intra IDR(s) + P frames"
    cfg_i = replace(cfg, skip_mc=True)        # IDR: no motion uploads
    cfg_p = replace(cfg, intra=(), intra_C=0)  # P scan: no intra stage

    # static slot map: IDR pinned in slot 0, P frames cycle 1..7
    fid_slot = {p.frame_id: 0 for p in iframes}
    for i, p in enumerate(pframes):
        fid_slot[p.frame_id] = 1 + i % (REF_SLOTS - 1)

    t0 = time.time()
    packed_i = [pack_frame(p, cfg_i, fid_slot, real_slots=True)
                for p in iframes]
    packed = [pack_frame(p, cfg_p, fid_slot, real_slots=True)
              for p in pframes]
    t_pack = time.time() - t0
    print(f"# packed {nf} frames in {t_pack:.2f}s "
          f"({nf / t_pack:.1f} fps)", file=sys.stderr)

    dy = jnp.zeros((REF_SLOTS, H, W), jnp.int16)
    dcb = jnp.zeros((REF_SLOTS, H // 2, W // 2), jnp.int16)
    dcr = jnp.zeros((REF_SLOTS, H // 2, W // 2), jnp.int16)
    ty, tc = init_tables(cfg)

    # ---- blob programs: IDR as a 1-frame scan through the intra
    # program, P frames as one multi-frame scan; each batch ships as one
    # flat buffer per dtype (~4 transfers instead of ~20)
    from libde265_tpu.frame_program import (blob_meta, pack_blob,
                                            get_stream_program_blob)

    def mk_blob(pack_list, cfg_use):
        stacked = {k: np.stack([t[k] for t in pack_list])
                   for k in pack_list[0]}
        meta, totals = blob_meta(stacked)
        return pack_blob(stacked, meta, totals), \
            get_stream_program_blob(cfg_use, meta), meta, totals

    blob_i, iprog, meta_i, tot_i = mk_blob(packed_i, cfg_i)
    blob, sprog, meta_p, tot_p = mk_blob(packed, cfg_p)

    # native (C++) pack rate — the production path (fe_pack_frame fills
    # the blob buffers directly; numpy remains the I-frame / fallback
    # path and the byte-exact oracle, tests/test_native_pack.py)
    from libde265_tpu.frame_program import pack_blob_native
    t0 = time.time()
    nat = pack_blob_native(pframes, cfg_p, fid_slot, meta_p, tot_p)
    t_natp = time.time() - t0
    if nat is not None:
        assert all(np.array_equal(nat[d], blob[d]) for d in blob)
        t_pack_eff = t_natp + t_pack * len(iframes) / nf
        print(f"# native pack: {len(pframes)} P frames in {t_natp:.2f}s "
              f"({len(pframes) / t_natp:.1f} fps)", file=sys.stderr)
    else:
        t_pack_eff = t_pack
    islots = np.array([fid_slot[p.frame_id] for p in iframes], np.int32)
    out_slots = np.array([fid_slot[p.frame_id] for p in pframes], np.int32)

    # ---- verification round (also compiles): every frame, IDR included,
    # decodes on-device and is MD5-checked against the dec265 goldens
    def md5s(s):
        return [hashlib.md5(np.asarray(pl[s]).astype(np.uint8).tobytes())
                .hexdigest() for pl in (dy, dcb, dcr)]

    t0 = time.time()
    sdi = jax.device_put(blob_i)
    dy, dcb, dcr, ty, tc = iprog(dy, dcb, dcr, ty, tc,
                                 sdi, jnp.asarray(islots))
    want = [man["md5"][iframes[-1].poc][k] for k in ("y", "u", "v")]
    assert md5s(0) == want, f"IDR (fused intra): {md5s(0)} != {want}"
    pprog = get_program(cfg_p)
    for p, t in zip(pframes, packed):
        s_ = fid_slot[p.frame_id]
        dy, dcb, dcr, ty, tc = pprog(dy, dcb, dcr, ty, tc,
                                     {k: jnp.asarray(v) for k, v in t.items()},
                                     np.int32(s_))
        want = [man["md5"][p.poc][k] for k in ("y", "u", "v")]
        assert md5s(s_) == want, f"P frame poc {p.poc}: {md5s(s_)} != {want}"
    dy, dcb, dcr, ty, tc = iprog(dy, dcb, dcr, ty, tc,
                                 sdi, jnp.asarray(islots))
    sd = jax.device_put(blob)
    dy, dcb, dcr, ty, tc = sprog(dy, dcb, dcr, ty, tc,
                                 sd, jnp.asarray(out_slots))
    last_poc = {}
    for p in pframes:
        last_poc[fid_slot[p.frame_id]] = p.poc
    for s_, poc in last_poc.items():
        want = [man["md5"][poc][k] for k in ("y", "u", "v")]
        assert md5s(s_) == want, f"scan slot {s_} (poc {poc})"
    print(f"# verification (incl. compile): {time.time()-t0:.1f}s, IDR + "
          f"{len(pframes)} P frames MD5-match dec265 (no bootstrap)",
          file=sys.stderr)

    # ---- timed rounds: one upload + ONE dispatch per pass over the
    # stream; the headline is the best round (upload + compute), the
    # all-rounds mean ships alongside as serial_sustained_fps
    nfr = nf
    slots_j = jnp.asarray(out_slots)
    islots_j = jnp.asarray(islots)

    def timed_rounds():
        nonlocal dy, dcb, dcr, ty, tc
        ts = []
        for r in range(ROUNDS):
            t0 = time.time()
            sdi = jax.device_put(blob_i)
            dy, dcb, dcr, ty, tc = iprog(dy, dcb, dcr, ty, tc,
                                         sdi, islots_j)
            sd = jax.device_put(blob)
            dy, dcb, dcr, ty, tc = sprog(dy, dcb, dcr, ty, tc,
                                         sd, slots_j)
            jax.block_until_ready(dy)
            ts.append(time.time() - t0)
        return ts

    # ---- pipelined sustained throughput: parse / pack / upload+dispatch
    # run CONCURRENTLY across rounds (the deployment shape — dec265's
    # main loop feeds its threaded decoder the same way,
    # dec265.cc:681-781). A parse thread re-parses the stream per round
    # (fresh NativeFrontend), a pack pool re-packs it, and the main
    # thread uploads + dispatches; jax dispatch is async so upload of
    # round r+1 overlaps device compute of round r. Steady-state rate =
    # the slowest stage, not the sum.
    def pipelined_rounds(R, nworkers=2):
        nonlocal dy, dcb, dcr, ty, tc
        import multiprocessing as mp
        from multiprocessing import shared_memory
        ctx = mp.get_context("spawn")
        rq = ctx.Queue()
        aqs = [ctx.Queue() for _ in range(nworkers)]
        go = ctx.Event()
        procs = [ctx.Process(
            target=_pipe_worker,
            args=(w, nworkers, R, path, cfg_i, cfg_p,
                  tuple(fid_slot.items()), rq, aqs[w], go), daemon=True)
            for w in range(nworkers)]
        for p in procs:
            p.start()
        # attach to each worker's shm sets
        wviews = {}
        wshms = []
        n_ready = 0
        while n_ready < nworkers:
            kind, wid, names = rq.get()
            assert kind == "ready", kind
            sets = []
            for nm in names:
                vs = {}
                for kind2, dts in nm.items():
                    vs[kind2] = {}
                    for dt, (sname, dstr, size) in dts.items():
                        s = shared_memory.SharedMemory(name=sname)
                        wshms.append(s)
                        vs[kind2][dt] = np.frombuffer(
                            s.buf, dtype=np.dtype(dstr), count=size)
                sets.append(vs)
            wviews[wid] = sets
            n_ready += 1
        t0 = time.time()
        go.set()
        done = 0
        n_fin = 0
        while n_fin < nworkers:
            kind, nf2, ref = rq.get()
            if kind == "done":
                n_fin += 1
                continue
            wid, setid = ref
            vs = wviews[wid][setid]
            # private copies (~40 ms) so the worker can refill the set
            # while device_put/dispatch run async behind them
            bi = {dt: a.copy() for dt, a in vs["i"].items()}
            bp = {dt: a.copy() for dt, a in vs["p"].items()}
            aqs[wid].put(setid)
            sdi_r = jax.device_put(bi)
            dy, dcb, dcr, ty, tc = iprog(dy, dcb, dcr, ty, tc,
                                         sdi_r, islots_j)
            sd_r = jax.device_put(bp)
            dy, dcb, dcr, ty, tc = sprog(dy, dcb, dcr, ty, tc,
                                         sd_r, slots_j)
            done += nf2
        jax.block_until_ready(dy)
        dt = time.time() - t0
        # release EVERY exported view before closing the shm maps (the
        # loop locals vs/bi/bp still alias the last set; a lingering
        # export makes mmap.close() raise BufferError and the skipped
        # close leaks the segment — the round-4 artifact tail bug)
        vs = bi = bp = None
        sets = None           # attach-loop local: last worker's view set
        wviews.clear()
        import gc
        gc.collect()
        for s in wshms:
            try:
                s.close()
            except BufferError:
                pass
            # no explicit resource_tracker.unregister here: spawn
            # children share the parent's tracker process, so the
            # worker's unlink already removes the name — a second
            # remove raced it and made the tracker print KeyError
            # tracebacks into the artifact tail
        for p in procs:
            p.join(timeout=30)
        return done / dt

    ts = timed_rounds()
    n_done = ROUNDS * nfr
    fps = nfr / min(ts)
    serial_sustained = n_done / sum(ts)
    sustained = pipelined_rounds(max(ROUNDS, 8))

    # ---- diagnostics: compute-only (plans resident) and upload-only rates
    # isolate the device's own decode rate from the host->device link
    slots_d = jax.device_put(jnp.asarray(out_slots))
    t0 = time.time()
    for r in range(ROUNDS):
        dy, dcb, dcr, ty, tc = iprog(dy, dcb, dcr, ty, tc,
                                     sdi, islots_j)
    jax.block_until_ready(dy)
    iframe_ms = (time.time() - t0) / ROUNDS * 1000 / len(iframes)
    t0 = time.time()
    for r in range(ROUNDS):
        dy, dcb, dcr, ty, tc = sprog(dy, dcb, dcr, ty, tc,
                                     sd, slots_d)
    jax.block_until_ready(dy)
    p_fps = ROUNDS * len(pframes) / (time.time() - t0)
    dev_fps = ROUNDS * nfr / (ROUNDS * len(iframes) * iframe_ms / 1000
                              + ROUNDS * len(pframes) / p_fps)
    nbytes = sum(v.nbytes for v in blob.values()) + \
        sum(v.nbytes for v in blob_i.values())
    t0 = time.time()
    for r in range(2):
        jax.block_until_ready(jax.device_put(blob))
    up_mbps = 2 * nbytes / (time.time() - t0) / 1e6
    baseline = 36.0
    d = jax.devices()[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({
        "metric": "e2e_4k_decode_fps",
        "stream": STREAM,
        "value": round(fps, 2),
        "unit": "frames/s (real 4K stream, fused device decode, "
                "MD5-verified vs dec265; best round, upload+compute; "
                "fully-pipelined parse+pack+upload+compute rate in "
                "sustained_fps)",
        "vs_baseline": round(fps / baseline, 2),
        "sustained_fps": round(sustained, 2),
        "serial_sustained_fps": round(serial_sustained, 2),
        "fe_parse_fps": round(nf / t_parse, 1),
        "pack_fps": round(nf / t_pack_eff, 1),
        "pack_numpy_fps": round(nf / t_pack, 1),
        "device_only_fps": round(dev_fps, 2),
        "p_frames_device_fps": round(p_fps, 2),
        "iframe_device_ms": round(iframe_ms, 1),
        "upload_mb_per_frame": round(nbytes / nfr / 1e6, 1),
        "link_mbps": round(up_mbps, 1),
        "frames_timed": n_done,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices()),
                   "nvidia_smi": smi[0] if smi else None},
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }))


if __name__ == "__main__":
    main()
