"""Full device-side frame reconstruction: ties the batched JAX ops into one
per-frame pipeline (MC -> inter residual -> PCM -> intra wavefront ->
deblock -> SAO), all bit-exact vs the numpy reference backend.

This is the hybrid device path; reconstruct.reconstruct_frame (numpy) is the
oracle/fallback.
"""
import numpy as np

from .plan import MODE_INTRA, MODE_INTER


def reconstruct_frame_device(plan, dpb_images=None, bitdepth=None):
    """Returns [Y,Cb,Cr] uint8/uint16 planes; same contract as
    reconstruct.reconstruct_frame. bitdepth defaults to the SPS luma depth."""
    if bitdepth is None:
        bitdepth = plan.sps.BitDepthY
    import jax.numpy as jnp
    from .ops.inter_dense_jax import motion_compensate_frame_dense
    from .backend import pack_tu_batches, residual_batch_device, scatter_residuals
    from .ops.intra_jax import intra_reconstruct_device
    from .ops.transform_ref import scale_and_inv_transform
    from .ops.filters_fused_jax import apply_filters_fused

    sps = plan.sps
    H, W = plan.H, plan.W
    dt = np.uint8 if bitdepth == 8 else np.uint16
    cw, ch = ((W // sps.SubWidthC, H // sps.SubHeightC)
              if sps.ChromaArrayType != 0 else (0, 0))
    planes = [np.zeros((H, W), dt),
              np.zeros((ch, cw), dt),
              np.zeros((ch, cw), dt)]
    # 1) inter prediction (dense per-4x4-block, one program per resolution)
    if plan.pus:
        motion_compensate_frame_dense(plan, planes, dpb_images, bitdepth)
    # 2) inter TU residuals (batched by size class) + PCM paste
    maxv = (1 << bitdepth) - 1
    batches = {}
    for tu in plan.tus:
        if tu.cidx == -1:
            n = 1 << tu.log2
            planes[0][tu.y:tu.y + n, tu.x:tu.x + n] = tu.pcm_y
            if sps.ChromaArrayType:
                sw, sh = sps.SubWidthC, sps.SubHeightC
                cx, cy = tu.x // sw, tu.y // sh
                cnw, cnh = n // sw, n // sh
                planes[1][cy:cy + cnh, cx:cx + cnw] = tu.pcm_c[0]
                planes[2][cy:cy + cnh, cx:cx + cnw] = tu.pcm_c[1]
            continue
        if tu.pred_mode != MODE_INTER or tu.coeffs is None:
            continue
        if tu.transform_skip or tu.tq_bypass or \
                (sps.scaling_list_enable_flag):
            # rare paths: host residual (incl. explicit RDPCM — range
            # ext, inter ts/bypass only, slice.cc:3456-3462)
            from .reconstruct import _scaling_matrix
            smat = sdc = None
            if sps.scaling_list_enable_flag:
                smat, sdc = _scaling_matrix(sps.scaling_list, tu.log2, tu.cidx, False)
            n = 1 << tu.log2
            res = scale_and_inv_transform(tu.coeffs, tu.qp, tu.log2, False,
                                          tu.transform_skip, tu.tq_bypass,
                                          bitdepth, smat, sdc,
                                          rdpcm=(tu.explicit_rdpcm
                                                 if tu.explicit_rdpcm > 0
                                                 else 0))
            cur = planes[tu.cidx][tu.y:tu.y + n, tu.x:tu.x + n].astype(np.int32)
            planes[tu.cidx][tu.y:tu.y + n, tu.x:tu.x + n] = \
                np.clip(cur + res, 0, maxv).astype(dt)
            continue
        b = batches.setdefault((tu.log2, tu.cidx), {"c": [], "q": [], "x": [], "y": []})
        b["c"].append(tu.coeffs)
        b["q"].append(tu.qp)
        b["x"].append(tu.x)
        b["y"].append(tu.y)
    if batches:
        dev = [jnp.asarray(p, jnp.int32) for p in planes]
        for (log2, cidx), b in batches.items():
            res = residual_batch_device(jnp.asarray(np.stack(b["c"]).astype(np.int32)),
                                        jnp.asarray(np.asarray(b["q"], np.int32)),
                                        log2, False, bitdepth)
            dev[cidx] = scatter_residuals(dev[cidx], res,
                                          jnp.asarray(np.asarray(b["x"], np.int32)),
                                          jnp.asarray(np.asarray(b["y"], np.int32)),
                                          log2, maxv)
        for ci in range(3):
            planes[ci][...] = np.asarray(dev[ci]).astype(dt)
    # 3) intra wavefront
    if any(tu.cidx >= 0 and tu.pred_mode == MODE_INTRA for tu in plan.tus):
        intra_reconstruct_device(plan, planes, bitdepth)
    # 4) loop filters: deblock V+H + SAO fused into one program
    plan.planes = planes
    planes = apply_filters_fused(plan, planes)
    plan.planes = planes
    return planes
