#!/usr/bin/env python3
"""Generate 720p/1080p golden vectors (WPP / tiles / multi-slice) with our
encoder + the reference decoder as oracle, plus one enc265 intra stream.

These cover the realistic-size gap (reference validates up to 4K,
/root/reference/README.md:11-13): multi-CTB-row WPP, large tile grids and
big-MV behavior at scale. Committed under tests/data/, indexed by
manifest_big.json, exercised by slow-marked pytests and the front-end
throughput benchmark (tools/bench_frontend.py).
"""
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DEC = os.path.join(REPO, ".ref_build", "dec265", "dec265")
ENC = os.path.join(REPO, ".ref_build", "enc265", "enc265")
DATA = os.path.join(REPO, "tests", "data")

from libde265_tpu.encoder import Encoder, EncoderConfig  # noqa: E402
from gen_inter_streams import plane_md5s  # noqa: E402


def make_frames(n, w, h, seed=11):
    """Moving synthetic content: pan + noise texture + moving objects, so
    MVs, intra fallback and residuals are all exercised at scale."""
    rng = np.random.RandomState(seed)
    gy, gx = np.mgrid[0:h, 0:w]
    base = np.clip(90 + 70 * np.sin(gx / 13.0) * np.cos(gy / 11.0)
                   + rng.randint(0, 45, (h, w)), 0, 255).astype(np.uint8)
    frames = []
    for t in range(n):
        y = np.roll(base, (t * 3, t * 5), (0, 1)).copy()
        # moving rigid square (clean MC) + flashing block (intra refresh)
        bx, by = (31 * t) % (w - 64), (17 * t) % (h - 64)
        y[by:by + 64, bx:bx + 64] = 210
        fx, fy = (w // 2 + 67 * t) % (w - 32), (h // 3 + 29 * t) % (h - 32)
        y[fy:fy + 32, fx:fx + 32] = rng.randint(0, 255, (32, 32))
        u = np.clip(128 + 50 * np.sin(np.mgrid[0:h//2, 0:w//2][1] / 9.0 + t * .4),
                    0, 255).astype(np.uint8)
        v = np.clip(128 + 50 * np.cos(np.mgrid[0:h//2, 0:w//2][0] / 8.0 - t * .2),
                    0, 255).astype(np.uint8)
        frames.append([y, u, v])
    return frames


CASES = [
    # name, w, h, frames, config kwargs (our encoder)
    ("ld_720p_wpp", 1280, 720, 3,
     dict(qp=32, wpp=True, inter_mode="mixed", inter_residual=True,
          log2_ctb=6, cu_log2=4, num_ref_l0=2, temporal_mvp=True,
          disable_deblocking=False, sao=True)),
    ("ld_1080p_wpp", 1920, 1080, 3,
     dict(qp=34, wpp=True, inter_mode="mixed", inter_residual=True,
          log2_ctb=6, cu_log2=4, num_ref_l0=2, temporal_mvp=True,
          disable_deblocking=False, sao=True)),
    ("tiles44_1080p", 1920, 1080, 3,
     dict(qp=34, tiles=(4, 4), inter_mode="mixed", inter_residual=True,
          log2_ctb=6, cu_log2=4, disable_deblocking=False, sao=True)),
    ("bigmv_720p", 1280, 720, 3,
     dict(qp=32, inter_mode="mv", log2_ctb=6, cu_log2=4,
          mv_patterns=((133, 67), (-240, -125), (511, 3), (1, 2),
                       (-397, 241), (64, -64), (-2, -2), (300, 300)))),
    # per-CU jittered qpel MVs spread over all 256 (phase, alignment)
    # classes per axis: the class-masked matmul MC's general path, e2e
    ("mixedmv_720p", 1280, 720, 3,
     dict(qp=32, inter_mode="gmv", global_mv=(-20, -12), mv_jitter=6,
          inter_residual=True, log2_ctb=6, cu_log2=4, num_ref_l0=2,
          temporal_mvp=True, disable_deblocking=False, sao=True)),
]


def main():
    only = sys.argv[1:] or None
    path = os.path.join(DATA, "manifest_big.json")
    manifest = json.load(open(path)) if os.path.exists(path) else {}
    for name, w, h, nf, kw in CASES:
        if only and name not in only:
            continue
        cfg = EncoderConfig(width=w, height=h, **kw)
        enc = Encoder(cfg)
        stream = enc.encode(make_frames(nf, w, h))
        bit = os.path.join(DATA, f"{name}.bin")
        open(bit, "wb").write(stream)
        gold = os.path.join(DATA, f"{name}_gold.yuv")
        r = subprocess.run([DEC, "-q", "-o", gold, bit], capture_output=True,
                           text=True, timeout=600)
        assert r.returncode == 0, (name, r.stderr)
        manifest[name] = {"w": w, "h": h, "frames": nf,
                          "md5": plane_md5s(gold, w, h, nf, 1),
                          "bit_depth": 8, "size_bytes": len(stream)}
        os.remove(gold)   # large: only MD5s are committed
        print(f"{name}: {len(stream)} bytes", flush=True)
    # enc265 intra 720p (reference encoder, intra only — its inter RDO hangs)
    if not only or "intra_720p" in only:
        import zlib
        from gen_streams import synth_yuv
        yuv = os.path.join(DATA, "intra_720p_src.yuv")
        bit = os.path.join(DATA, "intra_720p.bin")
        gold = os.path.join(DATA, "intra_720p_gold.yuv")
        synth_yuv(yuv, 1280, 720, 2, seed=zlib.crc32(b"intra_720p") % 2**31)
        subprocess.run([ENC, "-i", yuv, "-o", bit, "-w", "1280", "-h", "720",
                        "-f", "2", "--sop-structure", "intra", "-q", "30"],
                       check=True, capture_output=True)
        subprocess.run([DEC, "-q", "-o", gold, bit], check=True,
                       capture_output=True)
        manifest["intra_720p"] = {"w": 1280, "h": 720, "frames": 2,
                                  "md5": plane_md5s(gold, 1280, 720, 2, 1),
                                  "bit_depth": 8,
                                  "size_bytes": os.path.getsize(bit)}
        os.remove(yuv)
        os.remove(gold)
        print(f"intra_720p: {os.path.getsize(bit)} bytes", flush=True)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
