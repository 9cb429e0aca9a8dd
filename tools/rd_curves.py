#!/usr/bin/env python3
"""Rate-distortion curve generator (counterpart of
/root/reference/tools/rd-curves.cc): encodes a YUV at several QPs with our
encoder, decodes, and reports bitrate vs PSNR points.

Usage: python tools/rd_curves.py -i in.yuv -w W -h H -f N [--qps 22,27,32,37]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np


def main():
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--help", action="help")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-w", "--width", type=int, required=True)
    ap.add_argument("-h", "--height", type=int, required=True)
    ap.add_argument("-f", "--frames", type=int, default=4)
    ap.add_argument("--qps", default="22,27,32,37")
    ap.add_argument("--fps", type=float, default=25.0)
    ap.add_argument("--rdo", action="store_true",
                    help="RD-optimized mode decision (encoder/rdo.py)")
    ap.add_argument("-o", "--out", help="write curve JSON to file")
    args = ap.parse_args()
    from libde265_tpu.encoder import Encoder, EncoderConfig
    from libde265_tpu.api import decode_stream_native
    from libde265_tpu.utils.quality import psnr
    w, h = args.width, args.height
    fsz = w * h * 3 // 2
    raw = open(args.input, "rb").read()
    nf = min(len(raw) // fsz, args.frames)
    frames = []
    for t in range(nf):
        b = t * fsz
        frames.append([
            np.frombuffer(raw[b:b + w*h], np.uint8).reshape(h, w),
            np.frombuffer(raw[b + w*h:b + w*h + (w//2)*(h//2)], np.uint8).reshape(h//2, w//2),
            np.frombuffer(raw[b + w*h + (w//2)*(h//2):b + fsz], np.uint8).reshape(h//2, w//2)])
    points = []
    for qp in (int(q) for q in args.qps.split(",")):
        # anchor and RDO runs share the same motion-search mode: the
        # "mixed" heuristic emits a structurally-valid but low-quality
        # prediction (~13 dB on pan content) and is useless as an RD
        # baseline
        enc = Encoder(EncoderConfig(width=w, height=h, qp=qp, rdo=args.rdo,
                                    inter_mode="mv", inter_residual=True))
        stream = enc.encode(frames)
        pics = decode_stream_native(stream)
        py = np.mean([psnr(p.planes[0], frames[i][0]) for i, p in enumerate(pics)])
        kbps = len(stream) * 8 * args.fps / nf / 1000
        points.append({"qp": qp, "kbps": round(kbps, 1), "psnr_y": round(float(py), 2)})
        print(f"qp={qp}: {kbps:.1f} kbit/s, PSNR-Y {py:.2f} dB")
    print(json.dumps(points))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(points, f)


if __name__ == "__main__":
    sys.exit(main())
