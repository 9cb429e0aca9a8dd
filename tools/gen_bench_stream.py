#!/usr/bin/env python3
"""Generate the 4K benchmark stream (tests/data/ld4k.bin) + golden MD5s.

A low-delay 3840x2160 stream from our encoder: IDR then pure-inter P
frames (mv+residual everywhere, 2 refs, TMVP, deblock+SAO on) — the shape
the fused device frame program targets, matching the reference's 4K
headline benchmark class (/root/reference/README.md:40, Tears of Steel
4K). dec265 is the oracle: the committed MD5s come from its output.

Usage: python tools/gen_bench_stream.py [n_frames]
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))
DEC = os.path.join(REPO, ".ref_build", "dec265", "dec265")
DATA = os.path.join(REPO, "tests", "data")

from libde265_tpu.encoder import Encoder, EncoderConfig  # noqa: E402
from gen_inter_streams import plane_md5s  # noqa: E402


def make_frames(n, w, h, seed=11):
    """Natural-video-like content at a realistic 4K bitrate: smooth
    texture with mild noise, global pan, moving objects. (Heavy noise
    content inflates the stream to ~400 Mbps — 10-20x a real 4K
    broadcast — which benchmarks entropy decoding of noise, not video.)"""
    np_rng = np.random.RandomState(seed)
    gy, gx = np.mgrid[0:h, 0:w]
    base = np.clip(90 + 70 * np.sin(gx / 37.0) * np.cos(gy / 29.0)
                   + 25 * np.sin((gx + 2 * gy) / 111.0)
                   + np_rng.randint(0, 9, (h, w)), 0, 255).astype(np.uint8)
    frames = []
    for t in range(n):
        y = np.roll(base, (t * 3, t * 5), (0, 1)).copy()
        bx, by = (31 * t) % (w - 256), (17 * t) % (h - 256)
        y[by:by + 256, bx:bx + 256] = 210
        fx, fy = (w // 2 + 67 * t) % (w - 128), (h // 3 + 29 * t) % (h - 128)
        y[fy:fy + 128, fx:fx + 128] = np.clip(
            128 + 40 * np.sin(np.mgrid[0:128, 0:128][1] / 11.0 + t),
            0, 255).astype(np.uint8)
        u = np.clip(128 + 50 * np.sin(np.mgrid[0:h//2, 0:w//2][1] / 41.0
                                      + t * .4), 0, 255).astype(np.uint8)
        v = np.clip(128 + 50 * np.cos(np.mgrid[0:h//2, 0:w//2][0] / 33.0
                                      - t * .2), 0, 255).astype(np.uint8)
        frames.append([y, u, v])
    return frames


def make_frames_light(n, w, h, seed=12):
    """Realistic-bitrate 4K content: the same structure as make_frames but
    without per-pixel noise — encodes near real-broadcast rates (~20-40
    Mbps at qp 37) instead of the ~150 Mbps stress content, matching the
    bitrate class of the reference's published 4K numbers
    (/root/reference/README.md:40, Tears of Steel)."""
    gy, gx = np.mgrid[0:h, 0:w]
    base = np.clip(90 + 70 * np.sin(gx / 37.0) * np.cos(gy / 29.0)
                   + 25 * np.sin((gx + 2 * gy) / 111.0), 0, 255) \
        .astype(np.uint8)
    frames = []
    for t in range(n):
        y = np.roll(base, (t * 3, t * 5), (0, 1)).copy()
        bx, by = (31 * t) % (w - 256), (17 * t) % (h - 256)
        y[by:by + 256, bx:bx + 256] = 210
        u = np.clip(128 + 50 * np.sin(np.mgrid[0:h//2, 0:w//2][1] / 41.0
                                      + t * .4), 0, 255).astype(np.uint8)
        v = np.clip(128 + 50 * np.cos(np.mgrid[0:h//2, 0:w//2][0] / 33.0
                                      - t * .2), 0, 255).astype(np.uint8)
        frames.append([y, u, v])
    return frames


def main():
    argv = sys.argv[1:]
    if "--res" in argv:            # drop the flag AND its operand
        i = argv.index("--res")
        argv = argv[:i] + argv[i + 2:]
    args = [a for a in argv if not a.startswith("--")]
    nf = int(args[0]) if args else 9
    light = "--light" in sys.argv
    mixed = "--mixed" in sys.argv
    # --res 1080p/720p: same content class at the reference's other two
    # published benchmark resolutions (README.md:36-40)
    res = "4k"
    if "--res" in sys.argv:
        res = sys.argv[sys.argv.index("--res") + 1]
    w, h = {"4k": (3840, 2160), "1080p": (1920, 1080),
            "720p": (1280, 720)}[res]
    # light: true-motion encode of the pan (content rolls by (3,5)/frame
    # => MV (-20,-12) qpel) so residual coding is sparse like a real
    # broadcast stream; mixed: same content but every CU's MV gets a
    # deterministic qpel jitter covering all 16 fractional-phase x 4
    # alignment classes per axis — the hardest MC shape (no constant-
    # class shortcuts, full class-sort machinery); heavy: arbitrary MVDs
    # force dense residuals
    wpp = "--wpp" in sys.argv      # entropy_coding_sync: dec265 -t4 can
                                   # actually thread these
    cfg = EncoderConfig(width=w, height=h, qp=37 if (light or mixed) else 34,
                        inter_mode="gmv" if (light or mixed) else "mv",
                        global_mv=(-20, -12),
                        mv_jitter=6 if mixed else 0,
                        inter_residual=True, log2_ctb=6, cu_log2=4,
                        num_ref_l0=2, temporal_mvp=True, wpp=wpp,
                        disable_deblocking=False, sao=True)
    enc = Encoder(cfg)
    frames = (make_frames_light if (light or mixed) else make_frames)(nf, w, h)
    t0 = time.time()
    stream = enc.encode(frames)
    print(f"encoded {nf} frames in {time.time()-t0:.0f}s, "
          f"{len(stream)} bytes", flush=True)
    name = "ld4k" if res == "4k" else "ld" + res
    name += "_mixed" if mixed else ("_light" if light else "")
    if wpp:
        name += "_wppb"
    bit = os.path.join(DATA, name + ".bin")
    open(bit, "wb").write(stream)
    gold = os.path.join(DATA, name + "_gold.yuv")
    r = subprocess.run([DEC, "-q", "-o", gold, bit], capture_output=True,
                       text=True, timeout=1800)
    assert r.returncode == 0, r.stderr
    path = os.path.join(DATA, "manifest_big.json")
    manifest = json.load(open(path)) if os.path.exists(path) else {}
    manifest[name] = {"w": w, "h": h, "frames": nf,
                        "md5": plane_md5s(gold, w, h, nf, 1),
                        "bit_depth": 8, "size_bytes": len(stream)}
    os.remove(gold)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    print(name + " done", flush=True)


if __name__ == "__main__":
    main()
