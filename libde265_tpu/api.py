"""Public decoding API, mirroring the de265_* C surface
(/root/reference/libde265/de265.h:190-430) in pythonic form:

    dec = new_decoder()
    push_data(dec, chunk)
    flush_data(dec)
    while decode(dec): ...
    pic = get_next_picture(dec)   # -> DecodedPicture or None
"""
import hashlib
from dataclasses import dataclass

import numpy as np

from .decoder import Decoder


@dataclass
class DecodedPicture:
    poc: int
    planes: list          # [Y, Cb, Cr] numpy arrays (conformance-cropped)
    plan: object = None   # decode-plan metadata (FramePlan) for structure
                          # inspection (tools/sherlock.py overlays)
    pts: object = None    # presentation timestamp (de265_get_image_PTS)
    route: str = None     # backend="device": "fused" / "hybrid" / "numpy"
                          # (device_stream.py), None on host backends

    @property
    def width(self):
        return self.planes[0].shape[1]

    @property
    def height(self):
        return self.planes[0].shape[0]

    @property
    def chroma_format(self):
        """de265_get_chroma_format: 0 mono, 1 4:2:0, 2 4:2:2, 3 4:4:4."""
        if self.plan is not None:
            return self.plan.sps.ChromaArrayType
        h, w = self.planes[0].shape
        if self.planes[1].size == 0:
            return 0
        ch, cw = self.planes[1].shape
        if cw * 2 == w:
            return 1 if ch * 2 == h else 2
        return 3

    def plane_md5(self, idx):
        """Per-plane MD5, the reference's SEI decoded-picture-hash oracle
        (sei.cc:251-270)."""
        return hashlib.md5(np.ascontiguousarray(self.planes[idx]).tobytes()).hexdigest()

    def to_yuv_bytes(self):
        return b"".join(np.ascontiguousarray(p).tobytes() for p in self.planes)


def new_decoder(**kw) -> Decoder:
    return Decoder(**kw)


def push_data(dec: Decoder, data: bytes, pts=None):
    dec.push_data(data, pts)


def push_nal(dec: Decoder, data: bytes, pts=None):
    dec.push_nal(data, pts)


def flush_data(dec: Decoder):
    dec.flush()


def decode(dec: Decoder) -> bool:
    return dec.decode()


def reset(dec: Decoder):
    """Reset decoder state for seeking (de265_reset)."""
    dec.reset()


def get_warning(dec: Decoder):
    """Pop the oldest typed warning code or None (de265_get_warning)."""
    return dec.get_warning()


def get_next_picture(dec: Decoder):
    p = dec.get_next_picture()
    if p is None:
        return None
    return DecodedPicture(poc=p.poc, planes=p.output_planes, plan=p.plan,
                          pts=p.pts)


def peek_next_picture(dec: Decoder):
    """Front of the output queue WITHOUT removing it
    (de265_peek_next_picture); pair with release_next_picture."""
    p = dec.dpb.peek_output()
    if p is None:
        return None
    return DecodedPicture(poc=p.poc, planes=p.output_planes, plan=p.plan,
                          pts=p.pts)


def release_next_picture(dec: Decoder):
    """Drop the front of the output queue (de265_release_next_picture)."""
    dec.dpb.pop_output()


def decode_stream(data: bytes, **kw):
    """Convenience: decode a whole Annex-B stream, return list of pictures."""
    dec = new_decoder(**kw)
    dec.push_data(data)
    dec.flush()
    out = []
    while True:
        more = dec.decode()
        while True:
            pic = get_next_picture(dec)
            if pic is None:
                break
            out.append(pic)
        if not more:
            break
    return out


class _RefShim:
    """Maps decode-order frame ids to reconstructed pictures for MC."""
    class _P:
        __slots__ = ("planes", "plan", "poc")

        def __init__(self):
            self.planes = None
            self.plan = None
            self.poc = 0

    def __init__(self):
        self.pics = {}

    def add(self, fid, plan, planes):
        p = self._P()
        p.plan, p.planes, p.poc = plan, planes, plan.poc
        self.pics[fid] = p


def parse_stream_native(data: bytes):
    """Parse a whole Annex-B stream with the C++ front-end
    (native/libhevc_frontend.so): parameter sets first, then every
    picture's FramePlan in decode order."""
    from .native_frontend import NativeFrontend
    from .bitstream.nal import split_annexb
    from .bitstream.paramsets import read_sps, read_pps
    spss, ppss = {}, {}
    for u in split_annexb(data):
        t = u.header.nal_unit_type
        try:
            if t == 33:
                s = read_sps(u.data)
                spss[s.seq_parameter_set_id] = s
            elif t == 34:
                p = read_pps(u.data, spss)
                ppss[p.pic_parameter_set_id] = p
        except (ValueError, IndexError, KeyError):
            # corrupted/truncated parameter set: skip the unit, decode
            # what remains (reference: add_warning + continue,
            # decctx.cc:1593-1595 / de265.h DE265_WARNING_SPS_HEADER_INVALID)
            continue
    return NativeFrontend().parse(data, spss, ppss)


def decode_stream_native(data: bytes, backend="numpy", **kw):
    """Decode a whole Annex-B stream using the C++ front-end
    (native/libhevc_frontend.so) + the selected reconstruction backend
    ("numpy" reference or "device" = the fused device-resident frame
    program, device_stream.py). Returns pictures in output order, same
    results either way."""
    if backend != "device":
        from .reconstruct import reconstruct_frame
    plans = parse_stream_native(data)
    refs = _RefShim()
    done = []
    if backend == "device":
        from .device_stream import DeviceStreamDecoder
        dev = DeviceStreamDecoder(plans, plans[0].sps) if plans else None
        if dev is not None:
            dev.decode_all()      # scan-batches runs of fast-path frames
        for plan in plans:
            if plan.nal_type != -1 and plan.output_flag:
                done.append(plan)
        for plan in done:
            refs.add(plan.frame_id, plan, dev.planes_of(plan.frame_id))
        return _order_and_crop(done, refs, {
            fid: f["route"] for fid, f in dev.frames.items()} if dev else {})
    for plan in plans:
        if plan.nal_type == -1:  # concealment frame: grey planes
            from .plan import grey_planes
            planes = grey_planes(plan.sps, plan.W, plan.H)
        else:
            planes = reconstruct_frame(plan, dpb_images=refs)
        refs.add(plan.frame_id, plan, planes)
        if plan.nal_type != -1 and plan.output_flag:
            done.append(plan)
    return _order_and_crop(done, refs)


def _order_and_crop(done, refs, routes=None):
    """Reorder decoded plans by POC within IDR-delimited groups, apply the
    conformance window, return DecodedPictures (tagged with their decode
    route when `routes` maps frame ids to one)."""
    out = []
    group = []
    for plan in done:
        if plan.nal_type in (19, 20) and group:  # IDR starts new group
            out.extend(sorted(group, key=lambda p: p.poc))
            group = []
        group.append(plan)
    out.extend(sorted(group, key=lambda p: p.poc))
    pics = []
    for plan in out:
        planes = refs.pics[plan.frame_id].planes
        sps = plan.sps
        if sps.conformance_window_flag:
            sw, shh = sps.SubWidthC, sps.SubHeightC
            l = sps.conf_win_left_offset * sw
            r = sps.conf_win_right_offset * sw
            t = sps.conf_win_top_offset * shh
            b = sps.conf_win_bottom_offset * shh
            cl, cr_, ct, cb2 = l // sw, r // sw, t // shh, b // shh
            planes = [planes[0][t:plan.H - b, l:plan.W - r],
                      planes[1][ct:planes[1].shape[0] - cb2, cl:planes[1].shape[1] - cr_],
                      planes[2][ct:planes[2].shape[0] - cb2, cl:planes[2].shape[1] - cr_]]
        pics.append(DecodedPicture(poc=plan.poc, planes=planes, plan=plan,
                                   route=(routes or {}).get(plan.frame_id)))
    return pics
