#!/usr/bin/env python3
"""Generate deterministic synthetic YUV content and encode HEVC test streams
with the reference encoder (built out-of-tree in .ref_build), then decode them
back with the reference decoder to produce golden YUV + per-plane MD5s.

The streams + golden MD5s are committed under tests/data/ and serve as the
bit-exactness oracle for the device decoder (replicating the SEI decoded-picture-
hash strategy of the reference: /root/reference/libde265/sei.cc:273-360).

Usage: python tools/gen_streams.py
"""
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENC = os.path.join(REPO, ".ref_build", "enc265", "enc265")
DEC = os.path.join(REPO, ".ref_build", "dec265", "dec265")
DATA = os.path.join(REPO, "tests", "data")


def synth_yuv(path, w, h, frames, seed=0):
    """Deterministic synthetic 4:2:0 8-bit content: gradients + moving blocks
    + texture, so intra modes / MC / residuals all get exercised."""
    rng = np.random.RandomState(seed)
    noise = rng.randint(0, 40, size=(h * 2, w * 2)).astype(np.float32)
    with open(path, "wb") as f:
        for t in range(frames):
            yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
            y = 60 + 80 * np.sin(xx / 17.0 + t * 0.3) * np.cos(yy / 23.0)
            y += noise[t % h : t % h + h, t % w : t % w + w]
            # moving square
            bx, by = (13 * t) % max(1, w - 16), (7 * t) % max(1, h - 16)
            y[by : by + 16, bx : bx + 16] = 200
            # diagonal edge (exercises angular intra)
            y += np.where((xx + yy + 3 * t) % 64 < 32, 20, -20)
            yq = np.clip(y, 0, 255).astype(np.uint8)
            u = np.clip(128 + 60 * np.sin(xx[::2, ::2] / 29.0 + t * 0.2), 0, 255).astype(np.uint8)
            v = np.clip(128 + 60 * np.cos(yy[::2, ::2] / 31.0 - t * 0.1), 0, 255).astype(np.uint8)
            f.write(yq.tobytes())
            f.write(u.tobytes())
            f.write(v.tobytes())


def plane_md5s(yuv_path, w, h, frames):
    """Per-frame, per-plane MD5 of the decoded YUV (the golden oracle)."""
    out = []
    fsz = w * h + 2 * (w // 2) * (h // 2)
    with open(yuv_path, "rb") as f:
        data = f.read()
    assert len(data) == fsz * frames, (len(data), fsz, frames)
    for t in range(frames):
        base = t * fsz
        yb = data[base : base + w * h]
        ub = data[base + w * h : base + w * h + (w // 2) * (h // 2)]
        vb = data[base + w * h + (w // 2) * (h // 2) : base + fsz]
        out.append(
            {
                "y": hashlib.md5(yb).hexdigest(),
                "u": hashlib.md5(ub).hexdigest(),
                "v": hashlib.md5(vb).hexdigest(),
            }
        )
    return out


STREAMS = [
    # name, w, h, frames, extra encoder args
    ("intra_64x64_q27", 64, 64, 2, ["--sop-structure", "intra"]),
    ("intra_64x64_q37", 64, 64, 2, ["--sop-structure", "intra", "-q", "37"]),
    ("intra_cif_q30", 352, 288, 3, ["--sop-structure", "intra", "-q", "30"]),
    ("intra_cif_q20_nxn", 352, 288, 2,
     ["--sop-structure", "intra", "-q", "20", "--CB-IntraPartMode", "fixed",
      "--CB-IntraPartMode-Fixed-partMode", "NxN"]),
    ("intra_cif_maxcb64", 352, 288, 2,
     ["--sop-structure", "intra", "--max-cb-size", "64", "-q", "24"]),
    # odd size (conformance window / partial CTBs)
    ("intra_104x72_q26", 104, 72, 2, ["--sop-structure", "intra", "-q", "26"]),
    ("lowdelay_cif_q28", 352, 288, 5, ["--sop-structure", "low-delay", "-q", "28"]),
    ("lowdelay_64x64_q30", 64, 64, 4, ["--sop-structure", "low-delay", "-q", "30"]),
    ("lowdelay_cif_mvsearch", 352, 288, 5,
     ["--sop-structure", "low-delay", "-q", "32", "--MEMode", "search"]),
    ("intra_720p_q30", 1280, 720, 2, ["--sop-structure", "intra", "-q", "30"]),
]


def main():
    os.makedirs(DATA, exist_ok=True)
    manifest = {}
    for name, w, h, frames, args in STREAMS:
        yuv = os.path.join(DATA, f"{name}_src.yuv")
        bit = os.path.join(DATA, f"{name}.bin")
        gold = os.path.join(DATA, f"{name}_gold.yuv")
        import zlib
        synth_yuv(yuv, w, h, frames, seed=zlib.crc32(name.encode()) % 2**31)
        subprocess.run(
            [ENC, "-i", yuv, "-o", bit, "-w", str(w), "-h", str(h),
             "-f", str(frames)] + args,
            check=True, capture_output=True)
        subprocess.run([DEC, "-q", "-o", gold, bit], check=True, capture_output=True)
        manifest[name] = {
            "w": w, "h": h, "frames": frames,
            "md5": plane_md5s(gold, w, h, frames),
            "size_bytes": os.path.getsize(bit),
        }
        os.remove(yuv)
        print(f"{name}: {os.path.getsize(bit)} bytes")
    with open(os.path.join(DATA, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    sys.exit(main())
