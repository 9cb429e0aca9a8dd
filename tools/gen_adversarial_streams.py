#!/usr/bin/env python3
"""Adversarial encoder-knob cross-products.

Every committed golden stream so far isolates one feature; real-world
(and conformance-suite) streams combine them. This emits vectors from
deliberately awkward knob CROSS-PRODUCTS — WPP x dependent slices x
10-bit x scaling lists, tiles x lossless x qp-delta, B x weighted x LT
refs, rext formats x tiles x transform-skip, ... — verifies each
against dec265 (the golden oracle) and writes manifest_adv.json.
tests/test_adversarial.py runs them through the native front-end + the
fused device path; tools/decodestreams.py picks the manifest up for the
soak. (Mirrors the spirit of the reference's decodestreams sweep,
/root/reference/scripts/decodestreams.py:46-74.)

Usage: python tools/gen_adversarial_streams.py
"""
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))
DEC = os.path.join(REPO, ".ref_build", "dec265", "dec265")
DATA = os.path.join(REPO, "tests", "data")

import hashlib

from libde265_tpu.encoder import Encoder, EncoderConfig  # noqa: E402
from gen_rext_streams import gen_frames                  # noqa: E402


# name -> (n_frames, EncoderConfig kwargs). 104x72 / 96x64: multi-CTB
# grids at CIF-ish cost. Combos chosen to collide feature state:
# context save/restore (WPP/dep-slices) under 10-bit + scaling-list
# dequant; tile boundaries under lossless + per-CU QP; B + weights +
# long-term refs; rext formats under tiles/tskip/SDH.
CASES = {
    "adv_wpp_dep10_scaling": (4, dict(
        width=104, height=72, qp=30, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, bit_depth=10,
        wpp=True, num_slices=2, dependent_slices=True,
        scaling_lists=True, sign_data_hiding=True, sao=True,
        disable_deblocking=False)),
    # partial-CTB x lossless x transform-skip: the round-4 known encoder
    # bug (transform_skip_flag emitted for transquant-bypassed CUs,
    # spec 7.3.8.11 omits it) — fixed round 5; this vector pins it
    "adv_lossless_tskip_partial": (4, dict(
        width=104, height=72, qp=32, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True,
        tq_bypass=True, transform_skip=True, tiles=(2, 2),
        sao=True, disable_deblocking=False, lf_across_tiles=False)),
    "adv_tiles_lossless": (4, dict(
        width=96, height=64, qp=32, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, tiles=(2, 2),
        tq_bypass=True, transform_skip=True,
        sao=True, disable_deblocking=False,
        lf_across_tiles=False)),
    "adv_b_wp_2ref": (6, dict(
        width=104, height=72, qp=31, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, b_frames=True,
        weighted_pred=True, luma_weight_delta=2, luma_offset=3,
        num_ref_l0=2, temporal_mvp=True,
        max_merge_cand=3, sao=True, disable_deblocking=False)),
    "adv_ltr_tsa_scaling": (6, dict(
        width=104, height=72, qp=31, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, use_ltr=True,
        temporal_layers=True, scaling_lists=True, num_ref_l0=2,
        temporal_mvp=True, sao=True, disable_deblocking=False)),
    "adv_422_tiles_tskip": (3, dict(
        width=104, height=72, qp=30, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, chroma_format=2,
        tiles=(2, 1), transform_skip=True, sign_data_hiding=True,
        sao=True, disable_deblocking=False)),
    "adv_444_12b_tskip": (3, dict(
        width=96, height=64, qp=28, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, chroma_format=3,
        bit_depth=12, sign_data_hiding=True, transform_skip=True,
        sao=True, disable_deblocking=False)),
    "adv_mono_wpp_sdh": (4, dict(
        width=104, height=72, qp=30, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, chroma_format=0,
        wpp=True, sign_data_hiding=True, sao=True,
        disable_deblocking=False)),
    "adv_dep_pcm_strong": (3, dict(
        width=104, height=72, qp=27, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, num_slices=2,
        dependent_slices=True, pcm=True, pcm_loop_filter_disable=True,
        strong_intra_smoothing=True, intra_period=2, sao=True,
        disable_deblocking=False)),
    # 1-CTB-wide pictures: WPP rows re-init the CABAC models instead of
    # inheriting a snapshot (slice.cc:4696-4703);
    # crossed with dependent slices to hit both width-1 restore branches
    "adv_w1_wpp": (4, dict(
        width=32, height=96, qp=30, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, wpp=True,
        sign_data_hiding=True, sao=True, disable_deblocking=False)),
    "adv_w1_wpp_dep": (4, dict(
        width=32, height=128, qp=30, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, wpp=True,
        num_slices=2, dependent_slices=True, sao=True,
        disable_deblocking=False)),
    # PCM inside rext chroma formats: the fused paste geometry is
    # per-axis (4:2:2 tall blocks scatter as two stacked squares,
    # 4:4:4 full-size) — round-5's last frame_compatible exclusion
    # (read_pcm_samples slice.cc:4144-4215)
    "adv_pcm_422": (3, dict(
        width=104, height=72, qp=29, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, chroma_format=2,
        pcm=True, intra_period=2, sao=True,
        disable_deblocking=False)),
    "adv_pcm_444": (3, dict(
        width=96, height=64, qp=29, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, chroma_format=3,
        pcm=True, intra_period=2, sao=True,
        disable_deblocking=False)),
    "adv_pcm_mono": (3, dict(
        width=104, height=72, qp=29, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, chroma_format=0,
        pcm=True, intra_period=2, sao=True,
        disable_deblocking=False)),
    "adv_cra_scaling_10b_amp": (5, dict(
        width=104, height=72, qp=30, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, bit_depth=10,
        use_cra=True, intra_period=3, scaling_lists=True, amp=True,
        temporal_mvp=True, num_ref_l0=2, sao=True,
        disable_deblocking=False)),
    # round-5 rext residual tools crossed with the parallel structures
    # (WPP ctx snapshots must carry StatCoeff, tiles re-init it, CCP
    # meets tile boundaries, TU chroma QP offsets meet the qp
    # predictor) — slice.cc:2937-3376, 3530-3635
    # (persistent Rice x WPP/dep-slices is intentionally not minted:
    # the reference leaves StatCoeff uninitialized across its WPP
    # thread contexts, so dec265 is not a well-defined oracle there —
    # encoder.py:248-253. Tiles re-init CABAC per tile: well-defined.)
    "adv_rice_tiles": (4, dict(
        width=104, height=72, qp=26, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, transform_skip=True,
        persistent_rice=True, tiles=(2, 1), sao=True,
        disable_deblocking=False)),
    "adv_ccp_tiles_444": (3, dict(
        width=96, height=64, qp=29, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, chroma_format=3,
        cross_comp_pred=True, tiles=(2, 1), sao=True,
        disable_deblocking=False)),
    "adv_erdpcm_dep": (4, dict(
        width=104, height=72, qp=29, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, tq_bypass=True,
        explicit_rdpcm=True, num_slices=2, dependent_slices=True,
        sao=True, disable_deblocking=False)),
    "adv_cqo_tiles": (4, dict(
        width=104, height=72, qp=29, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True,
        chroma_qp_offset_list=((4, -4), (-3, 3)), tiles=(2, 1),
        sao=True, disable_deblocking=False)),
    "adv_rot_tsctx_wpp": (4, dict(
        width=104, height=72, qp=28, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, transform_skip=True,
        tskip_rotation=True, transform_skip_context=True,
        implicit_rdpcm=True, wpp=True, sao=True,
        disable_deblocking=False)),
    "adv_rice_12b_444": (3, dict(
        width=96, height=64, qp=26, log2_ctb=5, cu_log2=4,
        inter_mode="mixed", inter_residual=True, bit_depth=12,
        chroma_format=3, transform_skip=True, persistent_rice=True,
        sao=True, disable_deblocking=False)),
}


def main():
    if not os.path.exists(DEC):
        sys.exit("build the reference first (see .claude/skills/verify)")
    man_path = os.path.join(DATA, "manifest_adv.json")
    man = json.load(open(man_path)) if os.path.exists(man_path) else {}
    ok, failed = [], []
    for name, (nf, kw) in CASES.items():
        try:
            cfg = EncoderConfig(**kw)
            enc = Encoder(cfg)
            frames = gen_frames(cfg.chroma_format, cfg.width, cfg.height,
                                cfg.bit_depth, nf, seed=17)
            stream = enc.encode(frames)
        except Exception as e:
            failed.append((name, f"encode: {type(e).__name__}: {e}"))
            continue
        path = os.path.join(DATA, name + ".bin")
        with open(path, "wb") as f:
            f.write(stream)
        # golden via dec265
        out = os.path.join("/tmp", name + ".yuv")
        r = subprocess.run([DEC, "-q", "-o", out, path],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0 or not os.path.exists(out):
            failed.append((name, f"dec265 rc={r.returncode}: "
                           f"{(r.stdout + r.stderr)[-200:]}"))
            os.remove(path)
            continue
        raw = np.fromfile(out, np.uint8)
        esz = 1 if cfg.bit_depth == 8 else 2
        cf = cfg.chroma_format
        sw = 2 if cf in (1, 2) else 1
        sh = 2 if cf == 1 else 1
        W, H = cfg.width, cfg.height
        ys = W * H * esz
        cs = (W // sw) * (H // sh) * esz if cf else 0
        fsz = ys + 2 * cs
        if raw.size != fsz * nf:
            failed.append((name, f"golden size {raw.size} != {fsz*nf}"))
            os.remove(path)
            continue
        md5s = []
        for i in range(nf):
            b = i * fsz
            rec = {"y": hashlib.md5(raw[b:b + ys].tobytes()).hexdigest()}
            if cf:
                rec["u"] = hashlib.md5(
                    raw[b + ys:b + ys + cs].tobytes()).hexdigest()
                rec["v"] = hashlib.md5(
                    raw[b + ys + cs:b + fsz].tobytes()).hexdigest()
            md5s.append(rec)
        man[name] = {"w": cfg.width, "h": cfg.height, "frames": nf,
                     "bit_depth": cfg.bit_depth,
                     "chroma_format": cfg.chroma_format,
                     "size_bytes": len(stream), "md5": md5s}
        os.remove(out)
        ok.append(name)
        print(f"{name}: {nf} frames, {len(stream)} B, dec265-verified",
              flush=True)
    with open(man_path, "w") as f:
        json.dump(man, f, indent=1, sort_keys=True)
    print(f"\n{len(ok)} generated: {ok}")
    for name, why in failed:
        print(f"FAILED {name}: {why}")


if __name__ == "__main__":
    main()
