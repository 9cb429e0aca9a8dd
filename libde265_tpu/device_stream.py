"""Device-resident stream decoding driver.

Owns the device DPB stacks and routes every frame through one of three
routes, recorded per frame in `frames[fid]["route"]`:

  "fused"  the fused frame program (frame_program.py), zero host
           round-trips;
  "hybrid" the hybrid device path (device_decode.py) for frames that use
           explicit RDPCM or TU-level chroma QP offsets;
  "numpy"  the numpy reference recon (reconstruct.py) for frames that use
           the other range-extension residual tools;
  "concealed" a grey frame standing in for a lost picture.

Hybrid and numpy results are inserted into the device stack so fused
frames can reference them. Pixels are downloaded only when a consumer
asks (output, MD5, or a host-route frame referencing a fused frame).

The reference decodes a picture with a thread pool + per-CTB progress
locks (decctx.cc:700-789); here each picture is one dispatch chained on
the donated DPB carry, with uploads of the next frames overlapping device
compute.
"""
import numpy as np

from .frame_program import (REF_SLOTS, frame_compatible, frame_has_intra,
                            frame_has_mc, stream_cfg, pack_frame,
                            get_program, get_stream_program, init_tables,
                            update_tables)


class _HostRefShim:
    """Maps frame ids to host planes for the hybrid path."""

    class _P:
        __slots__ = ("planes", "plan", "poc")

    def __init__(self, dec):
        self.dec = dec

    @property
    def pics(self):
        return self

    def __getitem__(self, fid):
        p = self._P.__new__(self._P)
        f = self.dec.frames[fid]
        p.planes = self.dec._host_planes(fid)
        p.plan = f["plan"]
        p.poc = f["plan"].poc
        return p


class DeviceStreamDecoder:
    """Decode a parsed plan list with a device-resident DPB."""

    def __init__(self, plans, sps):
        import jax
        import jax.numpy as jnp
        self.jax, self.jnp = jax, jnp
        self.plans = plans
        self.cfg = stream_cfg(plans, sps)
        H, W = self.cfg.H, self.cfg.W
        # chroma stack geometry per format (mono: 1-row dummies, never
        # read). Since round 4 every chroma format runs the fused fast
        # path: 4:2:0 with chroma tile tables, 4:2:2/4:4:4 with the
        # dense in-program epel, mono luma-only.
        fmt = self.cfg.chroma_fmt
        self.mono = fmt == 0
        self.Hc, self.Wc = self.cfg.chroma_dims
        self.dy = jnp.zeros((REF_SLOTS, H, W), jnp.int16)
        self.dcb = jnp.zeros((REF_SLOTS, self.Hc, self.Wc), jnp.int16)
        self.dcr = jnp.zeros((REF_SLOTS, self.Hc, self.Wc), jnp.int16)
        # persistent MC tile tables, one build per decoded frame
        self.has_fast = True
        self.ty, self.tc = init_tables(self.cfg)
        self.slot_of = {}              # fid -> slot
        self.slot_fid = [None] * REF_SLOTS
        self.frames = {}               # fid -> {plan, host, route}
        self.last_use = self._last_uses(plans)
        # program variants sharing one carry: scan cfg (no intra stage)
        # for inter runs; the full cfg for intra-containing frames; a
        # skip_mc flavor for zero-PU frames (I-frames)
        from dataclasses import replace
        self.cfg_scan = replace(self.cfg, intra=(), intra_C=0)
        self._prog = None
        self._progs = {}
        if self.has_fast:
            self._prog = get_program(self.cfg_scan)
            self._progs[(False, True)] = (self.cfg_scan, self._prog)
            if self.cfg.intra:
                ci = self.cfg
                self._progs[(True, True)] = (ci, get_program(ci))
                c0 = replace(self.cfg, skip_mc=True)
                self._progs[(True, False)] = (c0, get_program(c0))
        self._mk_util_programs()
        self.dtype = np.uint8 if self.cfg.bitdepth == 8 else np.uint16

    def _last_uses(self, plans):
        last = {}
        for i, plan in enumerate(plans):
            # an output frame's pixels are needed until downloaded: keep it
            # host-copied on eviction (guards slot reuse on long streams)
            if plan.nal_type != -1 and getattr(plan, "output_flag", True):
                last[plan.frame_id] = len(plans)
            pm = plan._pu_arrays[0] if plan._pu_arrays is not None else None
            if pm is None or not pm.shape[0]:
                continue
            for l in range(2):
                used = pm[pm[:, 4 + l] > 0, 14 + l]
                for fid in np.unique(used):
                    last[int(fid)] = max(last.get(int(fid), -1), i)
        return last

    def _mk_util_programs(self):
        jax, jnp = self.jax, self.jnp
        cfg = self.cfg

        def insert(dy, dcb, dcr, ty, tc, y, cb, cr, slot):
            dy = jax.lax.dynamic_update_slice(dy, y[None], (slot, 0, 0))
            if cb is not None:
                dcb = jax.lax.dynamic_update_slice(dcb, cb[None],
                                                   (slot, 0, 0))
                dcr = jax.lax.dynamic_update_slice(dcr, cr[None],
                                                   (slot, 0, 0))
            if self.has_fast:
                ty, tc = update_tables(ty, tc, y, cb, cr, slot, cfg)
            return dy, dcb, dcr, ty, tc
        self._insert = jax.jit(insert, donate_argnums=(0, 1, 2, 3, 4))

        def fetch(dy, dcb, dcr, slot):
            H, W = dy.shape[1], dy.shape[2]
            Hc, Wc = dcb.shape[1], dcb.shape[2]
            y = jax.lax.dynamic_slice(dy, (slot, 0, 0), (1, H, W))[0]
            cb = jax.lax.dynamic_slice(dcb, (slot, 0, 0), (1, Hc, Wc))[0]
            cr = jax.lax.dynamic_slice(dcr, (slot, 0, 0), (1, Hc, Wc))[0]
            return y, cb, cr
        self._fetch = jax.jit(fetch)

    # ------------------------------------------------------------ slots
    def _alloc_slot(self, fid, frame_idx, needed):
        free = [s for s, f in enumerate(self.slot_fid) if f is None]
        if not free:
            # evict: prefer fids no longer referenced, then oldest
            cands = sorted(
                range(REF_SLOTS),
                key=lambda s: (self.slot_fid[s] in needed,
                               self.last_use.get(self.slot_fid[s], -1)))
            victim = cands[0]
            vfid = self.slot_fid[victim]
            if self.last_use.get(vfid, -1) >= frame_idx:
                # still needed later: keep a host copy before eviction
                self._host_planes(vfid)
            del self.slot_of[vfid]
            self.slot_fid[victim] = None
            free = [victim]
        s = free[0]
        self.slot_of[fid] = s
        self.slot_fid[s] = fid
        return s

    def _do_insert(self, planes, slot):
        jnp = self.jnp
        cb = cr = None
        if not self.mono:
            cb = jnp.asarray(planes[1].astype(np.int16))
            cr = jnp.asarray(planes[2].astype(np.int16))
        (self.dy, self.dcb, self.dcr, self.ty, self.tc) = \
            self._insert(
                self.dy, self.dcb, self.dcr, self.ty, self.tc,
                jnp.asarray(planes[0].astype(np.int16)),
                cb, cr, np.int32(slot))

    def _ensure_in_stack(self, fid, frame_idx, needed):
        if fid in self.slot_of:
            return self.slot_of[fid]
        planes = self._host_planes(fid)
        s = self._alloc_slot(fid, frame_idx, needed)
        self._do_insert(planes, s)
        return s

    def _host_planes(self, fid):
        f = self.frames[fid]
        if f["host"] is None:
            if fid not in self.slot_of:
                raise KeyError(
                    f"frame {fid} was evicted from its DPB slot before "
                    f"download (decode_all_pipelined(keep_outputs=False) "
                    f"throughput mode) — decode with keep_outputs=True "
                    f"to pin outputs until planes_of()")
            s = self.slot_of[fid]
            y, cb, cr = self._fetch(self.dy, self.dcb, self.dcr,
                                    np.int32(s))
            if self.mono:
                z = np.zeros((0, 0), self.dtype)
                f["host"] = [np.asarray(y).astype(self.dtype), z, z]
            else:
                f["host"] = [np.asarray(y).astype(self.dtype),
                             np.asarray(cb).astype(self.dtype),
                             np.asarray(cr).astype(self.dtype)]
        return f["host"]

    # ----------------------------------------------------------- decode
    def ref_fids(self, plan):
        pm = plan._pu_arrays[0] if plan._pu_arrays is not None else None
        if pm is None or not pm.shape[0]:
            return set()
        out = set()
        for l in range(2):
            out |= set(int(v) for v in np.unique(pm[pm[:, 4 + l] > 0,
                                                    14 + l]))
        return out

    def decode_plan(self, plan, frame_idx):
        """Decode one frame; registers it in the device DPB.
        Returns nothing — use host_planes(fid) / fetch later."""
        jnp = self.jnp
        fid = plan.frame_id
        needed = self.ref_fids(plan)
        if plan.nal_type == -1:           # concealment: grey frame
            from .plan import grey_planes
            planes = grey_planes(plan.sps, self.cfg.W, self.cfg.H)
            self._record(plan, planes, "concealed")
            s = self._alloc_slot(fid, frame_idx, needed)
            self._do_insert(planes, s)
            return

        if frame_compatible(plan) and self._fast_ok(plan):
            for rf in needed:
                self._ensure_in_stack(rf, frame_idx, needed)
            s = self._alloc_slot(fid, frame_idx, needed)
            self._run_fast(plan, s)
            self._record(plan, None, "fused")
        else:
            from .frame_program import frame_uses_rext_tools
            refs = _HostRefShim(self)
            if frame_uses_rext_tools(plan):
                # rext residual tools (CCP / implicit RDPCM / rotation /
                # disabled smoothing): reference recon implements them
                # all; the frame still lands in the device DPB
                from .reconstruct import reconstruct_frame
                planes = reconstruct_frame(plan, dpb_images=refs)
                route = "numpy"
            else:
                from .device_decode import reconstruct_frame_device
                planes = reconstruct_frame_device(
                    plan, dpb_images=refs, bitdepth=self.cfg.bitdepth)
                route = "hybrid"
            self._record(plan, planes, route)
            s = self._alloc_slot(fid, frame_idx, needed)
            self._do_insert(planes, s)

    def _record(self, plan, host, route):
        self.frames[plan.frame_id] = {"plan": plan, "host": host,
                                      "route": route}

    def route_counts(self):
        """{route: number of frames} over every frame decoded so far."""
        out = {}
        for f in self.frames.values():
            out[f["route"]] = out.get(f["route"], 0) + 1
        return out

    def _fast_ok(self, plan):
        if frame_has_intra(plan) and not self.cfg.intra:
            return False
        return self.has_fast

    def _run_fast(self, plan, out_slot):
        jnp = self.jnp
        key = (frame_has_intra(plan), frame_has_mc(plan))
        cfg, prog = self._progs.get(key) or self._progs[(False, True)]
        t = pack_frame(plan, cfg, self.slot_of, real_slots=True)
        td = {k: jnp.asarray(v) for k, v in t.items()}
        (self.dy, self.dcb, self.dcr, self.ty, self.tc) = \
            prog(self.dy, self.dcb, self.dcr,
                 self.ty, self.tc, td, np.int32(out_slot))

    def decode_all(self):
        """Decode the whole plan list; maximal runs of consecutive
        fast-path frames go through the lax.scan stream program as ONE
        dispatch (get_stream_program) instead of one dispatch per frame."""
        i, n = 0, len(self.plans)
        while i < n:
            run = self._collect_fast_run(i)
            if len(run) >= 2:
                self._run_fast_scan(run)
                i += len(run)
            else:
                self.decode_plan(self.plans[i], i)
                i += 1

    def _collect_fast_run(self, i0):
        """Simulate slot allocation forward from plan i0; returns
        [(plan, frame_idx, out_slot, packed_tensors), ...] for the maximal
        batchable run. Stops when a frame needs the hybrid path, a ref
        upload from host, or an eviction that would require a host copy."""
        sim_of = dict(self.slot_of)
        sim_fid = list(self.slot_fid)
        run = []
        for i in range(i0, len(self.plans)):
            plan = self.plans[i]
            if plan.nal_type == -1 or not frame_compatible(plan) \
                    or frame_has_intra(plan) or not self._fast_ok(plan) \
                    or type(self) is not DeviceStreamDecoder:
                break                  # intra frames: singleton dispatch
            needed = self.ref_fids(plan)
            if any(rf not in sim_of for rf in needed):
                break                      # ref needs a host upload
            free = [s for s, f in enumerate(sim_fid) if f is None]
            if free:
                s = free[0]
            else:
                cands = sorted(
                    range(REF_SLOTS),
                    key=lambda s: (sim_fid[s] in needed,
                                   self.last_use.get(sim_fid[s], -1)))
                s = cands[0]
                vfid = sim_fid[s]
                if vfid in needed or self.last_use.get(vfid, -1) >= i:
                    break                  # eviction needs a host copy
                del sim_of[vfid]
            sim_of[plan.frame_id] = s
            sim_fid[s] = plan.frame_id
            run.append((plan, i, s,
                        pack_frame(plan, self.cfg_scan, sim_of,
                                   real_slots=True)))
        return run

    def _run_fast_scan(self, run):
        from .frame_program import (blob_meta, pack_blob,
                                    get_stream_program_blob)
        jnp = self.jnp
        stacked = {k: np.stack([t[k] for (_, _, _, t) in run])
                   for k in run[0][3]}
        meta, totals = blob_meta(stacked)
        buf = {k: jnp.asarray(v)
               for k, v in pack_blob(stacked, meta, totals).items()}
        slots = jnp.asarray([s for (_, _, s, _) in run], dtype=jnp.int32)
        sprog = get_stream_program_blob(self.cfg_scan, meta)
        (self.dy, self.dcb, self.dcr, self.ty, self.tc) = sprog(
            self.dy, self.dcb, self.dcr, self.ty, self.tc,
            buf, slots)
        for (plan, i, s, _) in run:
            fid = plan.frame_id
            # mirror _alloc_slot bookkeeping for the simulated choices
            vfid = self.slot_fid[s]
            if vfid is not None and vfid in self.slot_of:
                del self.slot_of[vfid]
            self.slot_of[fid] = s
            self.slot_fid[s] = fid
            self._record(plan, None, "fused")

    def planes_of(self, fid):
        return self._host_planes(fid)

    # ------------------------------------------------- pipelined decode
    def schedule_slots(self, keep_outputs=False):
        """Precompute (plan, frame_idx, out_slot) for every frame of a
        fully fast-path stream. Slot choices depend only on plan
        metadata, never on device results, so the whole schedule is
        known before the first dispatch — this is what lets pack run
        ahead of the device on worker threads. Raises
        PipelineUnsupported when any frame needs the hybrid path or a
        host pixel copy (callers fall back to decode_all)."""
        last_use = self.last_use if keep_outputs else \
            self._last_uses_refs_only()
        sim_of, sim_fid = dict(self.slot_of), list(self.slot_fid)
        out = []
        for i, plan in enumerate(self.plans):
            if plan.nal_type == -1 or not frame_compatible(plan) \
                    or not self._fast_ok(plan):
                raise PipelineUnsupported(f"frame {i}: hybrid path")
            needed = self.ref_fids(plan)
            if any(rf not in sim_of for rf in needed):
                raise PipelineUnsupported(f"frame {i}: ref not resident")
            free = [s for s, f in enumerate(sim_fid) if f is None]
            if free:
                s = free[0]
            else:
                cands = sorted(
                    range(REF_SLOTS),
                    key=lambda s: (sim_fid[s] in needed,
                                   last_use.get(sim_fid[s], -1)))
                s = cands[0]
                vfid = sim_fid[s]
                if vfid in needed or last_use.get(vfid, -1) >= i:
                    raise PipelineUnsupported(
                        f"frame {i}: would evict needed frame {vfid}")
                del sim_of[vfid]
            sim_of[plan.frame_id] = s
            sim_fid[s] = plan.frame_id
            out.append((plan, i, s))
        return out

    def _last_uses_refs_only(self):
        """last_use from reference dependencies only: output pictures
        are NOT pinned until download (throughput mode — the consumer
        drains slots off-host, as dec265 -q discards its output)."""
        last = {}
        for i, plan in enumerate(self.plans):
            pm = plan._pu_arrays[0] if plan._pu_arrays is not None else None
            if pm is None or not pm.shape[0]:
                continue
            for l in range(2):
                used = pm[pm[:, 4 + l] > 0, 14 + l]
                for fid in np.unique(used):
                    last[int(fid)] = max(last.get(int(fid), -1), i)
        return last

    def decode_all_pipelined(self, batch=8, pack_workers=2,
                             keep_outputs=True):
        """decode_all with the host stages running AHEAD of the device:
        the slot schedule is precomputed, frames are packed on a worker
        pool and assembled into per-dtype blob batches on a builder
        thread, and the main thread only uploads + dispatches. Dispatch
        is async (jax enqueues), so upload of batch k+1 overlaps device
        compute of batch k. The reference's analog is its decode loop
        feeding a threaded CTB pool (dec265.cc:681-781, decctx.cc:700-
        789); here the pipeline axis is whole frame batches.
        Falls back to decode_all when the stream leaves the fast path."""
        try:
            sched = self.schedule_slots(keep_outputs=keep_outputs)
        except PipelineUnsupported:
            return self.decode_all()
        import queue as _q
        import threading
        from concurrent.futures import ThreadPoolExecutor
        from dataclasses import replace
        from .frame_program import (blob_meta, pack_blob,
                                    get_stream_program_blob)
        jnp = self.jnp

        # batches of consecutive same-kind frames; intra frames batch
        # separately (their program variant carries the intra stage)
        groups = []
        for item in sched:
            plan = item[0]
            kind = (frame_has_intra(plan), frame_has_mc(plan))
            if groups and groups[-1][0] == kind \
                    and len(groups[-1][1]) < batch:
                groups[-1][1].append(item)
            else:
                groups.append((kind, [item]))
        kinds = {}
        for kind, _ in groups:
            if kind not in kinds:
                if kind == (False, True):
                    kinds[kind] = self.cfg_scan
                elif kind[0]:
                    kinds[kind] = self.cfg if kind[1] \
                        else replace(self.cfg, skip_mc=True)
                else:       # zero-PU, zero-intra (skipped frame)
                    kinds[kind] = replace(self.cfg_scan, skip_mc=True)
        slot_map = {item[0].frame_id: item[2] for item in sched}

        def pack_one(args):
            plan, _, _ = args
            kind = (frame_has_intra(plan), frame_has_mc(plan))
            return pack_frame(plan, kinds[kind], slot_map,
                              real_slots=True)

        q = _q.Queue(maxsize=4)
        meta_cache = {}

        def builder():
            from .frame_program import pack_blob_native
            try:
                with ThreadPoolExecutor(max_workers=pack_workers) as ex:
                    for kind, items in groups:
                        slots = np.asarray([s for (_, _, s) in items],
                                           np.int32)
                        ck = (kind, len(items))
                        if ck in meta_cache:
                            meta, totals = meta_cache[ck]
                            bufs = pack_blob_native(
                                [it[0] for it in items], kinds[kind],
                                slot_map, meta, totals)
                            if bufs is not None:
                                q.put((kinds[kind], meta, bufs, slots,
                                       items))
                                continue
                        packed = list(ex.map(pack_one, items))
                        stacked = {k: np.stack([t[k] for t in packed])
                                   for k in packed[0]}
                        meta, totals = blob_meta(stacked)
                        meta_cache[ck] = (meta, totals)
                        q.put((kinds[kind], meta,
                               pack_blob(stacked, meta, totals), slots,
                               items))
            except BaseException as e:      # surface in the consumer
                q.put(e)
                return
            q.put(None)

        th = threading.Thread(target=builder, daemon=True)
        th.start()
        while True:
            got = q.get()
            if got is None:
                break
            if isinstance(got, BaseException):
                raise got
            cfg_use, meta, bufs, slots, items = got
            prog = get_stream_program_blob(cfg_use, meta)
            dbuf = {k: jnp.asarray(v) for k, v in bufs.items()}
            (self.dy, self.dcb, self.dcr, self.ty, self.tc) = prog(
                self.dy, self.dcb, self.dcr, self.ty, self.tc,
                dbuf, jnp.asarray(slots))
            for (plan, i, s) in items:
                fid = plan.frame_id
                vfid = self.slot_fid[s]
                if vfid is not None and vfid in self.slot_of:
                    del self.slot_of[vfid]
                self.slot_of[fid] = s
                self.slot_fid[s] = fid
                self._record(plan, None, "fused")
        th.join()


class PipelineUnsupported(Exception):
    """Stream needs the hybrid path / host copies; use decode_all."""


class ShardedStreamDecoder(DeviceStreamDecoder):
    """Tile-column sharded variant: compatible inter frames of a
    tile-encoded stream decode via parallel.tile_shard's shard_map
    program over an ndev-device mesh (one tile column per device)."""

    def __init__(self, plans, sps, mesh):
        super().__init__(plans, sps)
        from .parallel.tile_shard import (get_sharded_program, split_strips,
                                          strip_geometry)
        self.mesh = mesh
        self.ndev = mesh.shape["t"]
        self._split = split_strips
        self._geom = strip_geometry
        self._get_prog = get_sharded_program

    def _fast_ok(self, plan):
        if frame_has_intra(plan):
            # intra frames run the UNSHARDED fused program (replicated)
            # — the band-scan/wavefront doesn't tile-shard yet, but the
            # numpy hybrid fallback is orders of magnitude slower
            return DeviceStreamDecoder._fast_ok(self, plan)
        pps = plan.pps
        if not getattr(pps, "tiles_enabled_flag", False):
            return False
        if plan.sps.ChromaArrayType != 1:
            return False       # sharded strips assume 4:2:0 chroma dims
        # one tile COLUMN per device; arbitrary (non-uniform) boundaries
        # are fine — strips pad to the widest column (pps.h:109-151)
        return pps.num_tile_columns == self.ndev

    def _run_fast(self, plan, out_slot):
        if frame_has_intra(plan):
            return DeviceStreamDecoder._run_fast(self, plan, out_slot)
        jnp = self.jnp
        _, ws, _ = self._geom(plan, self.ndev)
        sprog = self._get_prog(self.cfg_scan, self.mesh, tuple(ws))
        tsh, trep, x0w = self._split(plan, self.cfg_scan, self.slot_of,
                                     self.ndev)
        tsh = {k: jnp.asarray(v) for k, v in tsh.items()}
        trep = {k: jnp.asarray(v) for k, v in trep.items()}
        self.dy, self.dcb, self.dcr = sprog(
            self.dy, self.dcb, self.dcr, tsh, trep, jnp.asarray(x0w),
            jnp.asarray(np.array([out_slot], np.int32)))
