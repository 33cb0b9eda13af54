"""Reference ``.pth`` checkpoints of the iw3, inpaint, cliqa and stlizer
rows, built from the plain PyTorch modules of tests/torchref/.

Each state dict is a reference module's seeded torch init with every
BatchNorm given seeded running statistics and affine terms (so that
folding it into the convs is not the identity) and the inpaint nets' mask
token drawn (it starts at zero).  Plain PyTorch: the parity tests and
``chip_smoke.py`` both build their checkpoints here.
"""
import torch

# envelope name -> (envelope kwargs, reference kind, the reference
# module's kwargs)
ROWS = {
    "sbs.row_flow_v2": ({}, "row_flow_v2", {}),
    "sbs.row_flow_v3": ({}, "row_flow_v3", {}),
    "sbs.mlbw": ({"num_layers": 2, "base_dim": 32}, "mlbw", {}),
    "sbs.mlbw_l2": ({}, "mlbw", {}),
    "sbs.mlbw_l4": ({}, "mlbw", dict(num_layers=4)),
    "sbs.mask_mlbw_l2": ({}, "mlbw", dict(hole_mask=True)),
    "inpaint.light_inpaint_v1": ({}, "light_inpaint_v1", {}),
    "inpaint.light_video_inpaint_v1": ({}, "light_video_inpaint_v1", {}),
    "inpaint.light_video_inpaint_v1_small": ({}, "light_video_inpaint_v1", {}),
    "inpaint.light_video_inpaint_v1_medium": (
        {}, "light_video_inpaint_v1", dict(base_dim=128, lv2_mlp_ratio=2)),
    "inpaint.light_video_inpaint_v1_large": (
        {}, "light_video_inpaint_v1", dict(base_dim=192, lv2_mlp_ratio=2)),
    "iw3.depth_aa": ({}, "depth_aa", {}),
    "iw3.sod_v1": ({}, "sod_v1", {}),
    "iw3.dsod_v1": ({}, "sod_v1", {}),
    "cliqa.jpeg_quality": ({}, "jpeg_quality", {}),
    "cliqa.grain_noise_level": ({}, "grain_noise_level", {}),
    "cliqa.scale_factor": ({}, "scale_factor", {}),
    "stlizer.light_outpaint_v1": ({}, "light_outpaint_v1", {}),
}


@torch.no_grad()
def seeded_bn(module, seed):
    """Give every BatchNorm of ``module`` seeded statistics and affine
    terms (eval mode)."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            n = m.num_features
            m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
            m.running_var.copy_(torch.rand(n, generator=g) * 0.5 + 0.75)
            m.weight.copy_(torch.rand(n, generator=g) * 0.5 + 0.75)
            m.bias.copy_(torch.randn(n, generator=g) * 0.05)
    return module.eval()


def reference_state(kind, seed=0, **kw):
    """(state dict, its reference module) of ``kind``."""
    import torchref.cliqa as cliqa
    from torchref import inpaint, iw3_models, outpaint, u2netp
    torch.manual_seed(seed)
    if kind == "sod_v1":
        net = seeded_bn(u2netp.U2NETP(in_ch=6), seed)
        return {f"u2netp.{k}": v for k, v in net.state_dict().items()}, net
    M = {"row_flow_v2": iw3_models.RowFlowV2, "row_flow_v3": iw3_models.RowFlowV3,
         "mlbw": iw3_models.MLBW, "light_inpaint_v1": inpaint.LightInpaintV1,
         "light_video_inpaint_v1": inpaint.LightVideoInpaintV1,
         "depth_aa": inpaint.DepthAA, "light_outpaint_v1": outpaint.LightOutpaintV1,
         "jpeg_quality": cliqa.JPEGQuality,
         "grain_noise_level": cliqa.GrainNoiseLevel,
         "scale_factor": cliqa.ScaleFactor}[kind]
    tm = seeded_bn(M(**kw), seed)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if name == "mask_bias":
                p.copy_(torch.randn(p.shape) * 0.1)
    return tm.state_dict(), tm


def save_pth(path, name, kwargs, sd):
    """``sd`` saved at ``path`` in the nunif envelope."""
    torch.save({"nunif_model": 1, "name": name, "kwargs": kwargs,
                "state_dict": sd, "updated_at": "test"}, path)
    return str(path)
