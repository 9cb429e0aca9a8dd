"""GOP-sharded multi-device decode: one GOP per mesh device, zero
collectives.

IRAP pictures are self-contained restart points (SURVEY §5: the natural
checkpoint/shard boundary; the reference leaves frame parallelism as a
TODO, decctx.cc:904-910). A closed-GOP stream therefore decodes as PURE
data parallelism over a `jax.sharding.Mesh`: every device runs the same
fused frame program on its own GOP — IDR through the intra wavefront
variant, then a lax.scan over the P frames — with its own private DPB /
tile-table carry. No cross-device communication exists inside the
program, so frames/s scaling is communication-free by construction: only
the input bits and output frames cross the interconnect, never reference
pixels.

Bit-exactness: tests/test_gop_shard.py decodes gop1080p on a virtual CPU
mesh and checks every frame's MD5 against the dec265 goldens.
"""
from dataclasses import replace
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from ..frame_program import (REF_SLOTS, decode_frame_device, pack_frame,
                             frame_compatible, frame_has_intra,
                             frame_has_mc, init_tables)


def split_gop_plans(plans):
    """Group parsed plans into closed GOPs (each starts at an IRAP)."""
    gops = []
    cur = []
    for p in plans:
        if p.nal_type != -1 and 16 <= p.nal_type <= 23 and cur:
            gops.append(cur)
            cur = []
        cur.append(p)
    if cur:
        gops.append(cur)
    return gops


def pack_gops(gops, cfg_i, cfg_p):
    """Host: per-GOP packed tensors with a uniform frame count (shorter
    GOPs pad by repeating their last P frame — re-decoding a frame into
    its own slot is idempotent). Returns (ti, islots, ts, oslots, F)."""
    F = max(len(g) for g in gops)
    ti_l, isl, ts_l, osl = [], [], [], []
    for g in gops:
        assert frame_has_intra(g[0]) and not frame_has_mc(g[0]), \
            "each GOP must start with a pure-intra IRAP"
        assert all(frame_compatible(p) for p in g)
        fid_slot = {g[0].frame_id: 0}
        for i, p in enumerate(g[1:]):
            fid_slot[p.frame_id] = 1 + i % (REF_SLOTS - 1)
        ti_l.append(pack_frame(g[0], cfg_i, fid_slot, real_slots=True))
        isl.append(0)
        pk = [pack_frame(p, cfg_p, fid_slot, real_slots=True)
              for p in g[1:]]
        slots = [fid_slot[p.frame_id] for p in g[1:]]
        while len(pk) < F - 1:           # idempotent tail padding
            pk.append(pk[-1])
            slots.append(slots[-1])
        ts_l.append({k: np.stack([t[k] for t in pk]) for k in pk[0]})
        osl.append(slots)
    ti = {k: np.stack([t[k] for t in ti_l]) for k in ti_l[0]}
    ts = {k: np.stack([t[k] for t in ts_l]) for k in ts_l[0]}
    return (ti, np.asarray(isl, np.int32), ts,
            np.asarray(osl, np.int32), F)


def get_gop_program(cfg, mesh, emit_frames=False):
    """shard_map program: leading axis = GOPs, sharded over mesh axis
    'g'; per shard: IDR via the intra/skip_mc cfg, then scan the P run.
    emit_frames: also return every decoded frame's planes as scan ys
    (uint8/int16) — the consumer API path; the bench keeps stacks-only
    (slot MD5s)."""
    cfg_i = replace(cfg, skip_mc=True)
    cfg_p = replace(cfg, intra=(), intra_C=0)
    gspec = P("g")
    odt = jnp.uint8 if cfg.bitdepth == 8 else jnp.int16

    def shard_body(dy, dcb, dcr, ty, tc, ti, islot, ts, oslots):
        ti = {k: v[0] for k, v in ti.items()}
        carry = decode_frame_device(dy[0], dcb[0], dcr[0], ty[0], tc[0],
                                    ti, islot[0, 0], cfg_i)

        def grab(c, slot):
            return (c[0][slot].astype(odt), c[1][slot].astype(odt),
                    c[2][slot].astype(odt))

        def step(c, xs):
            t, slot = xs
            c = decode_frame_device(*c, t, slot, cfg_p)
            return c, (grab(c, slot) if emit_frames else 0)

        f0 = grab(carry, islot[0, 0]) if emit_frames else None
        carry, ys = jax.lax.scan(step, carry,
                                 ({k: v[0] for k, v in ts.items()},
                                  oslots[0]))
        out = tuple(x[None] for x in carry)
        if emit_frames:
            frames = tuple(
                jnp.concatenate([a[None], y], axis=0)[None]
                for a, y in zip(f0, ys))
            return out + frames
        return out

    nout = 8 if emit_frames else 5
    kw = dict(mesh=mesh,
              in_specs=(gspec, gspec, gspec, gspec, gspec,
                        gspec, gspec, gspec, gspec),
              out_specs=(gspec,) * nout)
    try:
        fn = shard_map(shard_body, check_vma=False, **kw)
    except TypeError:  # pre-0.8 jax spelling
        fn = shard_map(shard_body, check_rep=False, **kw)
    return jax.jit(fn, donate_argnums=(0, 1, 2, 3, 4))


def _shard_args(plans, sps, mesh, emit_frames=False):
    from ..frame_program import stream_cfg
    G = mesh.shape["g"]
    gops = split_gop_plans(plans)
    assert len(gops) >= G, (len(gops), G)
    gops = gops[:G]
    cfg = stream_cfg([p for g in gops for p in g], sps)
    cfg_i = replace(cfg, skip_mc=True)
    cfg_p = replace(cfg, intra=(), intra_C=0)
    ti, islots, ts, oslots, F = pack_gops(gops, cfg_i, cfg_p)
    H, W = cfg.H, cfg.W
    dy = jnp.zeros((G, REF_SLOTS, H, W), jnp.int16)
    dcb = jnp.zeros((G, REF_SLOTS, H // 2, W // 2), jnp.int16)
    dcr = jnp.zeros((G, REF_SLOTS, H // 2, W // 2), jnp.int16)
    ty1, tc1 = init_tables(cfg)
    ty = jnp.broadcast_to(ty1[None], (G,) + ty1.shape)
    tc = jnp.broadcast_to(tc1[None], (G,) + tc1.shape)
    prog = get_gop_program(cfg, mesh, emit_frames=emit_frames)
    args = (dy, dcb, dcr, ty, tc,
            {k: jnp.asarray(v) for k, v in ti.items()},
            jnp.asarray(islots)[:, None],
            {k: jnp.asarray(v) for k, v in ts.items()},
            jnp.asarray(oslots))
    return prog, args, gops


def lower_sharded_for_census(plans, sps, mesh):
    """Lower (without running) the GOP-sharded program: the bench counts
    collective ops in the HLO — the zero-collective scaling claim is
    CHECKED, not asserted (tools/bench_gop_device.py)."""
    prog, args, _ = _shard_args(plans, sps, mesh)
    return prog.lower(*args)


def decode_gops_sharded(plans, sps, mesh, emit_frames=False):
    """Decode a closed-GOP stream with one GOP per mesh device. Returns
    {frame_id: (slot, gop_idx)} plus the final device stacks (G, R, H, W)
    for MD5 verification/download; with emit_frames, out[5:8] carry
    every decoded frame's planes (G, F, H, W) in per-GOP decode order."""
    prog, args, gops = _shard_args(plans, sps, mesh,
                                   emit_frames=emit_frames)
    return prog(*args), frame_slots(gops), gops


def frame_slots(gops):
    """{frame_id: (gop_idx, slot, poc)}: where each frame of the sharded
    decode is written (the last write per slot survives)."""
    where = {}
    for gi, g in enumerate(gops):
        fid_slot = {g[0].frame_id: 0}
        for i, p in enumerate(g[1:]):
            fid_slot[p.frame_id] = 1 + i % (REF_SLOTS - 1)
        for p in g:
            where[p.frame_id] = (gi, fid_slot[p.frame_id], p.poc)
    return where
