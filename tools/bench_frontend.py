#!/usr/bin/env python3
"""Front-end throughput benchmark: native parse (CABAC pool + overlapped
motion replay) and plan extraction, per stream and thread count.

The serial CABAC stage is the classic software-decode ceiling
(reference: frame-parallel thread pool, decctx.cc); this measures
whether the host front end can feed the device pipeline at target rate.
Writes one JSON line per (stream, threads) config (and the list to
out.json when given).

Usage: python tools/bench_frontend.py [out.json]
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DATA = os.path.join(REPO, "tests", "data")

# heavy self-generated streams (38-157 Mbps) plus the comparable-bitrate
# "light" streams — the reference's published 284/150/36 fps numbers were
# measured on broadcast-rate content (BASELINE.md), so the light rows are
# the apples-to-apples parse-throughput comparison.
STREAMS = ("ld_1080p_wpp", "gop1080p", "ld4k_light", "ld4k",
           "ld720p_light", "ld1080p_light")


def bench(stream, threads, reps=3):
    from libde265_tpu.native_frontend import NativeFrontend
    from libde265_tpu.bitstream.nal import split_annexb
    from libde265_tpu.bitstream.paramsets import read_sps, read_pps
    path = os.path.join(DATA, stream + ".bin")
    with open(path, "rb") as f:
        data = f.read()
    spss, ppss = {}, {}
    for u in split_annexb(data):
        t = u.header.nal_unit_type
        if t == 33:
            s = read_sps(u.data)
            spss[s.seq_parameter_set_id] = s
        elif t == 34:
            p = read_pps(u.data, spss)
            ppss[p.pic_parameter_set_id] = p
    os.environ["FE_THREADS"] = str(threads)
    best_push = best_ext = 0.0
    n = 0
    for _ in range(reps):
        fe = NativeFrontend()
        t0 = time.time()
        n = fe.lib.fe_push_stream(fe.h, data, len(data))
        t1 = time.time()
        frames = fe.extract_all(n, spss, ppss)   # pooled, as parse() does
        t2 = time.time()
        best_push = max(best_push, n / (t1 - t0))
        best_ext = max(best_ext, n / (t2 - t1))
        del frames, fe
    sps = list(spss.values())[0]
    return {"stream": stream, "threads": threads, "frames": n,
            "w": sps.pic_width_in_luma_samples,
            "h": sps.pic_height_in_luma_samples,
            "mbps": round(len(data) * 8 * 30 / max(n, 1) / 1e6, 1),
            "parse_fps": round(best_push, 1),
            "extract_fps": round(best_ext, 1),
            "pipeline_fps": round(1 / (1 / best_push + 1 / best_ext), 1)}


def main():
    out = []
    for stream in STREAMS:
        if not os.path.exists(os.path.join(DATA, stream + ".bin")):
            continue
        for threads in (1, 4):
            r = bench(stream, threads)
            print(json.dumps(r))
            out.append(r)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
