"""The fused frame programs lower for CUDA (cross-lowered on the CPU).

For the I- and P-frame configurations of real streams in every format
the fused path runs, the CUDA lowering must hold no custom call (every
stage is plain XLA, no hand-written or interpreted kernel), and every float32
dot_general must ask for HIGHEST precision: the 10-bit MC exactness
argument (ops/mc_mxu_jax.py) does not hold under TF32."""
import dataclasses
import json
import os
import re

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")
STREAMS = [
    ("manifest_inter.json", "p_mv"),            # 8-bit 4:2:0
    ("manifest_inter.json", "p_10bit"),         # 10-bit
    ("manifest_rext.json", "rext_422_inter"),   # 4:2:2
    ("manifest_rext.json", "rext_444_inter"),   # 4:4:4
    ("manifest_rext.json", "rext_mono_inter"),  # monochrome
    ("manifest_inter.json", "p_pcm"),           # PCM
    ("manifest_inter.json", "p_scaling"),       # scaling lists
]


def _lower_cuda(name, kind):
    import jax
    import jax.numpy as jnp
    from libde265_tpu.api import parse_stream_native
    from libde265_tpu.frame_program import (REF_SLOTS, stream_cfg,
                                            pack_frame, frame_has_intra,
                                            frame_has_mc, init_tables,
                                            decode_frame_device)
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        plans = parse_stream_native(f.read())
    cfg = stream_cfg(plans, plans[0].sps)
    if kind == "I":
        plan = next(p for p in plans if frame_has_intra(p)
                    and not frame_has_mc(p))
        cfg = dataclasses.replace(cfg, skip_mc=True)
    else:
        plan = next(p for p in plans if frame_has_mc(p))
        if not frame_has_intra(plan):
            cfg = dataclasses.replace(cfg, intra=(), intra_C=0)
    fid_slot = {p.frame_id: i % REF_SLOTS for i, p in enumerate(plans)}
    t = {k: jnp.asarray(v) for k, v in
         pack_frame(plan, cfg, fid_slot, real_slots=True).items()}
    Hc, Wc = cfg.chroma_dims
    dy = jnp.zeros((REF_SLOTS, cfg.H, cfg.W), jnp.int16)
    dc = jnp.zeros((REF_SLOTS, Hc, Wc), jnp.int16)
    ty, tc = init_tables(cfg)
    fn = jax.jit(lambda *a: decode_frame_device(*a, cfg))
    low = fn.trace(dy, dc, dc, ty, tc, t, np.int32(1)) \
        .lower(lowering_platforms=("cuda",))
    return cfg, low.as_text()


@pytest.mark.parametrize("kind", ["I", "P"])
@pytest.mark.parametrize("mf,name", STREAMS)
def test_fused_program_lowers_for_cuda(mf, name, kind):
    with open(os.path.join(DATA, mf)) as f:
        assert name in json.load(f)
    cfg, txt = _lower_cuda(name, kind)
    targets = set(re.findall(r"stablehlo\.custom_call @([\w$.]+)", txt))
    assert not targets, targets
    dots = [l for l in txt.splitlines() if "stablehlo.dot_general" in l]
    f32 = [l for l in dots if re.search(r"-> tensor<[^>]*xf32>", l)]
    if kind == "P":
        assert f32, "the P program's MC matmuls run in float32"
    for line in f32:
        assert "precision = [HIGHEST, HIGHEST]" in line, line
