#!/usr/bin/env python3
"""sherlock — interactive HEVC stream debugger (sherlock265 counterpart).

The reference ships a Qt player (sherlock265/) that scrubs a stream and
toggles structure overlays (visualize.cc: CB/TB grids, PB motion, QP
map, slice/tile colouring). This environment has no display server, so
this equivalent renders the same layers into a single
self-contained HTML file: frame slider + per-layer checkboxes, each
layer an RGBA image stacked with CSS; works in any browser, ships as
one artifact.

Usage:
  python tools/sherlock.py stream.bin [-o report.html] [-n max_frames]
                           [--backend host|device]

Layers (all derived from the decode-plan metadata, not re-parsed):
  cb   coding-block grid        (visualize.cc:draw_CB_grid)
  tb   transform-block grid     (visualize.cc:draw_TB_grid)
  mv   motion vectors           (visualize.cc:draw_Motion)
  qp   QP heat map              (visualize.cc:draw_QuantPY)
  slice per-CTB slice index colouring
"""
import argparse
import base64
import io
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _png_b64(arr):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG", optimize=True)
    return base64.b64encode(buf.getvalue()).decode()


def _layer_rgba(plan, name):
    """Render one overlay on a transparent canvas."""
    from libde265_tpu.utils import visualize as V
    H, W = plan.H, plan.W
    rgba = np.zeros((H, W, 4), np.uint8)
    rgb = rgba[..., :3]
    if name == "qp":
        qp = V._expand_plan_grid(plan, plan.qp_y.astype(np.int32))
        heat = np.clip((qp - 20) * 6, 0, 255).astype(np.uint8)
        rgba[..., 0] = heat
        rgba[..., 3] = heat // 2
        return rgba
    if name == "slice":
        sl = np.repeat(np.repeat(plan.slice_addr_rs, 1 << plan.sps.Log2CtbSizeY,
                                 0), 1 << plan.sps.Log2CtbSizeY, 1)[:H, :W]
        pal = np.array([(60, 120, 216), (216, 120, 60), (120, 216, 60),
                        (216, 60, 180), (60, 216, 200), (200, 200, 60)],
                       np.uint8)
        rgba[..., :3] = pal[sl % len(pal)]
        rgba[..., 3] = 56
        return rgba
    before = rgb.copy()
    if name == "cb":
        V.draw_cb_grid(plan, rgb)
    elif name == "tb":
        V.draw_tb_grid(plan, rgb)
    elif name == "mv":
        V.draw_motion(plan, rgb)
    rgba[..., 3] = np.where((rgb != before).any(-1), 230, 0)
    return rgba


HTML = """<!doctype html><meta charset="utf-8">
<title>sherlock — {name}</title>
<style>
 body {{ font: 13px sans-serif; background: #181818; color: #ddd;
        margin: 16px; }}
 #stack {{ position: relative; }}
 #stack img {{ position: absolute; left: 0; top: 0; image-rendering:
              pixelated; width: {dw}px; }}
 #stack img.base {{ position: relative; }}
 label {{ margin-right: 14px; }}
 #bar {{ margin: 8px 0; }}
 input[type=range] {{ width: 420px; vertical-align: middle; }}
</style>
<h3>sherlock — {name} ({w}x{h}, {n} frames)</h3>
<div id="bar">
 frame <input type="range" id="fr" min="0" max="{nm1}" value="0">
 <span id="info"></span><br>
 {boxes}
</div>
<div id="stack"></div>
<script>
const D = {data};
const META = {meta};
const LAYERS = {layers};
const stack = document.getElementById("stack");
function render() {{
  const f = +document.getElementById("fr").value;
  let html = `<img class="base" src="data:image/png;base64,${{D[f].base}}">`;
  for (const l of LAYERS)
    if (document.getElementById("ck_" + l).checked && D[f][l])
      html += `<img src="data:image/png;base64,${{D[f][l]}}">`;
  stack.innerHTML = html;
  const m = META[f];
  document.getElementById("info").textContent =
    ` POC ${{m.poc}} · ${{m.type}} · QP ${{m.qp}} · ${{m.slices}} slice(s)`;
}}
document.getElementById("fr").oninput = render;
for (const l of LAYERS)
  document.getElementById("ck_" + l).onchange = render;
render();
</script>
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("stream")
    ap.add_argument("-o", "--out", default=None)
    ap.add_argument("-n", "--frames", type=int, default=16)
    ap.add_argument("--backend", default="numpy",
                    choices=("numpy", "device"))
    ap.add_argument("--layers", default="cb,tb,mv,qp,slice")
    args = ap.parse_args()

    from libde265_tpu.api import decode_stream_native
    from libde265_tpu.utils.visualize import yuv_to_rgb

    with open(args.stream, "rb") as f:
        data = f.read()
    pics = decode_stream_native(data, backend=args.backend)
    layers = args.layers.split(",")
    frames, meta = [], []
    ST = {0: "B", 1: "P", 2: "I"}
    for pic in pics[:args.frames]:
        plan = pic.plan
        d = {"base": _png_b64(yuv_to_rgb(pic.planes))}
        hc, wc = pic.planes[0].shape     # conformance-cropped geometry
        for l in layers:
            d[l] = _png_b64(_layer_rgba(plan, l)[:hc, :wc])
        frames.append(d)
        sh = plan.slice_headers[0] if plan.slice_headers else None
        meta.append({"poc": plan.poc,
                     "type": ST.get(sh.slice_type, "?") if sh else "?",
                     "qp": sh.SliceQPY if sh else 0,
                     "slices": len(plan.slice_headers)})
    name = os.path.basename(args.stream)
    w, h = (pics[0].plan.W, pics[0].plan.H) if pics else (0, 0)
    boxes = " ".join(
        f'<label><input type="checkbox" id="ck_{l}" '
        f'{"checked" if l in ("cb", "mv") else ""}>{l}</label>'
        for l in layers)
    out = args.out or os.path.splitext(args.stream)[0] + "_sherlock.html"
    with open(out, "w") as f:
        f.write(HTML.format(name=name, w=w, h=h, dw=min(2 * w, 1280),
                            n=len(frames), nm1=max(len(frames) - 1, 0),
                            boxes=boxes, data=json.dumps(frames),
                            meta=json.dumps(meta),
                            layers=json.dumps(layers)))
    print(f"wrote {out} ({os.path.getsize(out)//1024} KiB, "
          f"{len(frames)} frames, layers: {', '.join(layers)})")


if __name__ == "__main__":
    main()
