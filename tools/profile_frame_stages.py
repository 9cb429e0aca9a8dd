#!/usr/bin/env python3
"""Per-stage timing of the fused decode program (ablation profile).

The device-only rate of the whole-stream scan program is the device-side
ceiling of the decoder; this tool compiles ablated variants of
frame_program.decode_frame_device (stage subsets) as scan programs over
the P frames of a real stream and reports ms/frame per variant, so the
deltas attribute the budget to: MC table build / MC gather+filter /
residuals / deblock / SAO / scan+DPB overhead. --no-mxu / --no-cmxu swap
in the tap-path MC. The IDRs run through the intra program ("idr":
compile seconds, device ms per IDR).
Times end in block_until_ready; needs a GPU.

Usage: python tools/profile_frame_stages.py [stream] [--rounds N]
Writes one JSON line per variant (stderr has progress).
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DATA = os.path.join(REPO, "tests", "data")

VARIANTS = [
    ("none", ()),                            # scan + DPB-insert overhead
    ("tables", ("tables",)),                 # + insert-time tile-table build
    ("mc_luma", ("mc", "mc_luma_only")),     # + luma MC only
    ("mc", ("mc",)),                         # + MC gather + filters
    ("mc_res", ("mc", "res")),               # + residual batches
    ("mc_res_dbk", ("mc", "res", "dbk")),    # + deblock V/H
    ("full", ("mc", "res", "dbk", "sao", "tables")),   # == bench.py
]


def main():
    from libde265_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    if jax.default_backend() != "gpu":
        sys.exit("profile_frame_stages.py needs a GPU")
    import jax.numpy as jnp
    import numpy as np
    from libde265_tpu.frame_program import (REF_SLOTS, stream_cfg,
                                            pack_frame, frame_compatible,
                                            frame_has_intra,
                                            decode_frame_device, init_tables,
                                            update_tables, get_program)
    from libde265_tpu.api import parse_stream_native

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    stream = args[0] if args else "ld4k_light"
    rounds = 6
    if "--rounds" in sys.argv:
        rounds = int(sys.argv[sys.argv.index("--rounds") + 1])
    with open(os.path.join(DATA, stream + ".bin"), "rb") as f:
        data = f.read()
    with open(os.path.join(DATA, "manifest_big.json")) as f:
        man = json.load(f)[stream]
    W, H = man["w"], man["h"]
    plans = parse_stream_native(data)
    cfg_full = stream_cfg(plans, plans[0].sps)
    cfg = cfg_full
    import dataclasses
    if "--no-cmxu" in sys.argv:      # A/B: tap-path chroma MC
        cfg = dataclasses.replace(cfg, mc_caps_c=())
    if "--no-mxu" in sys.argv:       # A/B: tap-path luma MC
        cfg = dataclasses.replace(cfg, mc_caps=())
    cfg = dataclasses.replace(cfg, intra=(), intra_C=0)  # P-scan variant
    pframes = [p for p in plans if p.nal_type != -1 and frame_compatible(p)
               and not frame_has_intra(p)]
    # timing only: every IDR sits in slot 0, P frames cycle 1..7
    fid_slot = {p.frame_id: 0 for p in plans if frame_has_intra(p)}
    for i, p in enumerate(pframes):
        fid_slot[p.frame_id] = 1 + i % (REF_SLOTS - 1)
    packed = [pack_frame(p, cfg, fid_slot, real_slots=True) for p in pframes]
    stacked = {k: np.stack([t[k] for t in packed]) for k in packed[0]}
    out_slots = np.array([fid_slot[p.frame_id] for p in pframes], np.int32)

    # timing only: the DPB anchor frame can be zeros (no MD5 check here)
    dy0 = jnp.zeros((REF_SLOTS, H, W), jnp.int16)
    dcb0 = jnp.zeros((REF_SLOTS, H // 2, W // 2), jnp.int16)
    dcr0 = jnp.zeros((REF_SLOTS, H // 2, W // 2), jnp.int16)
    ty0, tc0 = init_tables(cfg)
    ty0, tc0 = jax.jit(update_tables, static_argnames=("cfg",))(
        ty0, tc0, dy0[0], dcb0[0], dcr0[0], np.int32(0), cfg=cfg)

    sd = {k: jax.device_put(v) for k, v in stacked.items()}
    slots_d = jax.device_put(jnp.asarray(out_slots))
    nf = len(pframes)

    results = {}
    for name, stages in VARIANTS:
        def fn(dy, dcb, dcr, ty, tc, ts, oslots, _stages=stages):
            def step(carry, xs):
                t, slot = xs
                return decode_frame_device(*carry, t, slot, cfg,
                                           stages=_stages), 0
            carry, _ = jax.lax.scan(step, (dy, dcb, dcr, ty, tc),
                                    (ts, oslots))
            return carry
        prog = jax.jit(fn)       # no donation: reuse dy0 across variants
        t0 = time.time()
        st = jax.block_until_ready(prog(dy0, dcb0, dcr0, ty0, tc0, sd,
                                        slots_d))
        print(f"# {name}: compile+1st {time.time()-t0:.1f}s",
              file=sys.stderr, flush=True)
        t0 = time.time()
        for _ in range(rounds):
            st = prog(*st, sd, slots_d)
        jax.block_until_ready(st)
        dt = time.time() - t0
        ms = dt / (rounds * nf) * 1000.0
        results[name] = ms
        print(json.dumps({"variant": name, "ms_per_frame": round(ms, 3),
                          "fps": round(1000.0 / ms, 2)}), flush=True)

    # stage attribution from deltas
    attr = {
        "scan_dpb_overhead": results.get("none"),
        "mc_table_build": results.get("tables", 0) - results.get("none", 0),
        "mc_luma": results.get("mc_luma", 0) - results.get("none", 0),
        "mc_chroma_combine": results.get("mc", 0)
                             - results.get("mc_luma", 0),
        "mc_gather_filter": results.get("mc", 0) - results.get("none", 0),
        "residuals": results.get("mc_res", 0) - results.get("mc", 0),
        "deblock": results.get("mc_res_dbk", 0) - results.get("mc_res", 0),
        "sao": results.get("full", 0) - results.get("mc_res_dbk", 0)
               - (results.get("tables", 0) - results.get("none", 0)),
    }
    print(json.dumps({"stream": stream,
                      "attribution_ms": {k: round(v, 3)
                                         for k, v in attr.items()}}),
          flush=True)

    # IDRs through the intra program (skip_mc flavour, as device_stream)
    cfg_i = dataclasses.replace(cfg_full, skip_mc=True)
    iframes = [p for p in plans if p.nal_type != -1 and frame_has_intra(p)
               and frame_compatible(p)]
    prog = get_program(cfg_i)
    tis = [{k: jax.device_put(v) for k, v in
            pack_frame(p, cfg_i, {p.frame_id: 0}, real_slots=True).items()}
           for p in iframes]
    st = (dy0, dcb0, dcr0, ty0, tc0)
    st = tuple(jnp.copy(a) for a in st)        # the program donates them
    t0 = time.time()
    st = jax.block_until_ready(prog(*st, tis[0], np.int32(0)))
    compile_s = time.time() - t0
    t0 = time.time()
    for _ in range(rounds):
        for ti in tis:
            st = prog(*st, ti, np.int32(0))
    jax.block_until_ready(st)
    ms = (time.time() - t0) / (rounds * len(tis)) * 1000.0
    print(json.dumps({"variant": "idr", "n_idr": len(tis),
                      "intra_levels": cfg_i.intra_C,
                      "compile_plus_first_s": round(compile_s, 2),
                      "ms_per_idr": round(ms, 3)}), flush=True)


if __name__ == "__main__":
    main()
