#!/usr/bin/env python3
"""GOP-parallel host decode scaling benchmark: decodes the long
multi-IRAP 1080p stream (tests/data/gop1080p.bin, 16 IDR-delimited GOPs)
with 1/2/4/8 host worker processes via parallel/gop_parallel.py
(backend "numpy"; the device path is tools/bench_gop_device.py) and
reports frames/s and scaling
efficiency. Every run's output is MD5-verified against the dec265 goldens
(manifest_big.json), so the parallel split is proven bit-exact, not just
fast. Counterpart of the frame-level parallelism the reference leaves as a
TODO (/root/reference/libde265/decctx.cc:904-910).

Usage: python tools/bench_gop.py [--workers 1,2,4,8] [--stream gop1080p]
"""
import argparse
import hashlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DATA = os.path.join(REPO, "tests", "data")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", default="1,2,4,8")
    ap.add_argument("--stream", default="gop1080p")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")   # host workers only

    from libde265_tpu.parallel.gop_parallel import (decode_gop_parallel,
                                                    split_gops)
    man = json.load(open(os.path.join(DATA, "manifest_big.json")))[args.stream]
    with open(os.path.join(DATA, args.stream + ".bin"), "rb") as f:
        stream = f.read()
    w, h, nf = man["w"], man["h"], man["frames"]
    ngops = len(split_gops(stream))
    print(f"# {args.stream}: {nf} frames {w}x{h}, {ngops} GOPs", flush=True)

    ncpu = os.cpu_count()
    results = []
    base_fps = None
    for nw in (int(x) for x in args.workers.split(",")):
        t0 = time.time()
        frames = decode_gop_parallel(stream, workers=nw, native=True,
                                     backend="numpy")
        dt = time.time() - t0
        assert len(frames) == nf, (len(frames), nf)
        ysz, csz = w * h, (w // 2) * (h // 2)
        for i, (_poc, yuv) in enumerate(frames):
            got = [hashlib.md5(yuv[:ysz]).hexdigest(),
                   hashlib.md5(yuv[ysz:ysz + csz]).hexdigest(),
                   hashlib.md5(yuv[ysz + csz:]).hexdigest()]
            want = [man["md5"][i][k] for k in ("y", "u", "v")]
            assert got == want, f"workers={nw} frame {i}: MD5 mismatch"
        fps = nf / dt
        if base_fps is None:
            base_fps = fps
        eff = fps / (base_fps * min(nw, ncpu))
        results.append({"workers": nw, "fps": round(fps, 2),
                        "efficiency": round(eff, 3),
                        "oversubscribed": nw > ncpu})
        print(f"workers={nw}: {fps:.2f} fps, efficiency {eff:.1%}"
              f"{' (oversubscribed: %d cores)' % ncpu if nw > ncpu else ''}",
              flush=True)
    print(json.dumps({"stream": args.stream, "gops": ngops,
                      "cores": ncpu, "results": results}))


if __name__ == "__main__":
    main()
