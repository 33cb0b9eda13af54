"""Upstream PyTorch state dicts -> the flax-named parameter tree that
``models.flax_params`` loads (the port's own copy of the converters of
``nunif_tpu/models/torch_convert.py``: depth, the iw3 stereo and inpaint
nets, DepthAA, U2NETP, cliqa, stlizer's outpaint net, waifu2x,
imagenet's vgg11_bn and LPIPS's VGG16 trunk; the port does not import
it).

Works on numpy arrays or anything with ``.numpy()``.  Layout rules:
  Conv2d           (O, I, kh, kw) -> HWIO (kh, kw, I, O)
  ConvTranspose2d  (I, O, kh, kw) -> flax ConvTranspose(transpose_kernel=True)
                                     kernel (kh, kw, O, I)
  Linear           (O, I)         -> (I, O)
  LayerNorm        weight / bias  -> scale / bias
``flatten`` turns a nested tree into the ``{"a/b/c": array}`` form of
``from_flax``.
"""
from __future__ import annotations

import numpy as np


def _np(t):
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _key(prefix, name):
    return f"{prefix}.{name}" if prefix else name


def conv2d(sd, prefix):
    out = {"kernel": _np(sd[_key(prefix, "weight")]).transpose(2, 3, 1, 0)}
    if _key(prefix, "bias") in sd:
        out["bias"] = _np(sd[_key(prefix, "bias")])
    return out


def conv_transpose2d(sd, prefix):
    # torch weight (I, O, kh, kw) -> (kh, kw, O, I) for transpose_kernel=True
    out = {"kernel": _np(sd[_key(prefix, "weight")]).transpose(2, 3, 1, 0)}
    if _key(prefix, "bias") in sd:
        out["bias"] = _np(sd[_key(prefix, "bias")])
    return out


def linear(sd, prefix):
    out = {"kernel": _np(sd[_key(prefix, "weight")]).T}
    if _key(prefix, "bias") in sd:
        out["bias"] = _np(sd[_key(prefix, "bias")])
    return out


def layer_norm(sd, prefix):
    out = {}
    if _key(prefix, "weight") in sd:
        out["scale"] = _np(sd[_key(prefix, "weight")])
    if _key(prefix, "bias") in sd:
        out["bias"] = _np(sd[_key(prefix, "bias")])
    return out


def raw(sd, key):
    return _np(sd[key])


def dino_vit(sd, prefix: str, depth: int):
    """Map a timm/DINOv2 ViT state_dict subtree at ``prefix`` to the flax
    tree of nunif_tpu_torch.iw3.depth.dinov2.DinoVisionTransformer."""
    pre = {
        "cls_token": raw(sd, _key(prefix, "cls_token")),
        "pos_embed": raw(sd, _key(prefix, "pos_embed")),
        "patch_embed": conv2d(sd, _key(prefix, "patch_embed.proj")),
        "norm": layer_norm(sd, _key(prefix, "norm")),
    }
    for i in range(depth):
        b = _key(prefix, f"blocks.{i}")
        pre[f"blocks_{i}"] = {
            "norm1": layer_norm(sd, b + ".norm1"),
            "attn": {
                "qkv": linear(sd, b + ".attn.qkv"),
                "proj": linear(sd, b + ".attn.proj"),
            },
            "ls1": {"gamma": raw(sd, b + ".ls1.gamma")},
            "norm2": layer_norm(sd, b + ".norm2"),
            "mlp_fc1": linear(sd, b + ".mlp.fc1"),
            "mlp_fc2": linear(sd, b + ".mlp.fc2"),
            "ls2": {"gamma": raw(sd, b + ".ls2.gamma")},
        }
    return pre


def convert_depth_anything(sd, encoder: str):
    """Depth-Anything v1 / v2 (DINOv2 trunk + DPT head) -> the tree of
    ``iw3.depth.depth_anything.DepthAnything``."""
    from ..iw3.depth.dinov2 import VIT_CONFIGS
    head = _dpt_scratch(sd, "depth_head")
    for i in range(4):
        head[f"projects_{i}"] = conv2d(sd, f"depth_head.projects.{i}")
    head["resize_0"] = conv_transpose2d(sd, "depth_head.resize_layers.0")
    head["resize_1"] = conv_transpose2d(sd, "depth_head.resize_layers.1")
    head["resize_3"] = conv2d(sd, "depth_head.resize_layers.3")
    return {"pretrained": dino_vit(sd, "pretrained", VIT_CONFIGS[encoder]["depth"]),
            "depth_head": head}


def _dpt_scratch(sd, prefix="depth_head"):
    """DPT scratch (layer_rn + refinenets + output convs) shared by
    DA v1/v2 and VDA."""
    head = {}
    for i in range(1, 5):
        head[f"layer{i}_rn"] = conv2d(sd, f"{prefix}.scratch.layer{i}_rn")
        rf = f"{prefix}.scratch.refinenet{i}"
        block = {
            "resConfUnit2": {
                "conv1": conv2d(sd, rf + ".resConfUnit2.conv1"),
                "conv2": conv2d(sd, rf + ".resConfUnit2.conv2"),
            },
            "out_conv": conv2d(sd, rf + ".out_conv"),
        }
        if i != 4:
            block["resConfUnit1"] = {
                "conv1": conv2d(sd, rf + ".resConfUnit1.conv1"),
                "conv2": conv2d(sd, rf + ".resConfUnit1.conv2"),
            }
        head[f"refinenet{i}"] = block
    head["output_conv1"] = conv2d(sd, f"{prefix}.scratch.output_conv1")
    head["output_conv2_0"] = conv2d(sd, f"{prefix}.scratch.output_conv2.0")
    head["output_conv2_2"] = conv2d(sd, f"{prefix}.scratch.output_conv2.2")
    return head


def convert_midas_core(sd, backbone: str = "beit_l_384", prefix: str = ""):
    """Map a MiDaS DPT-BEiT torch state_dict (the released MiDaS v3.1
    layout: pretrained.model.* / pretrained.act_postprocess{1-4}.* /
    scratch.*) to the flax tree of nunif_tpu_torch.iw3.depth.midas.MidasCore.

    ``prefix``: e.g. "core.core." for ZoeDepth checkpoints that nest the
    MiDaS core."""
    from ..iw3.depth.midas import BEIT_CONFIGS
    cfg = BEIT_CONFIGS[backbone]
    p = prefix + "pretrained."
    m = p + "model."
    pre = {"cls_token": raw(sd, m + "cls_token"),
           "patch_embed": conv2d(sd, m + "patch_embed.proj")}
    for i in range(cfg["depth"]):
        b = f"{m}blocks.{i}"
        pre[f"blocks_{i}"] = {
            "norm1": layer_norm(sd, b + ".norm1"),
            "attn": {
                "qkv_kernel": _np(sd[b + ".attn.qkv.weight"]).T,
                "q_bias": raw(sd, b + ".attn.q_bias"),
                "v_bias": raw(sd, b + ".attn.v_bias"),
                "relative_position_bias_table": raw(
                    sd, b + ".attn.relative_position_bias_table"),
                "proj": linear(sd, b + ".attn.proj"),
            },
            "gamma_1": raw(sd, b + ".gamma_1"),
            "gamma_2": raw(sd, b + ".gamma_2"),
            "norm2": layer_norm(sd, b + ".norm2"),
            "mlp_fc1": linear(sd, b + ".mlp.fc1"),
            "mlp_fc2": linear(sd, b + ".mlp.fc2"),
        }
    out = {"pretrained": pre}
    for i in range(4):
        ap = f"{p}act_postprocess{i + 1}"
        out[f"readout_{i}"] = linear(sd, ap + ".0.project.0")
        out[f"projects_{i}"] = conv2d(sd, ap + ".3")
    out["resize_0"] = conv_transpose2d(sd, p + "act_postprocess1.4")
    out["resize_1"] = conv_transpose2d(sd, p + "act_postprocess2.4")
    out["resize_3"] = conv2d(sd, p + "act_postprocess4.4")
    s = prefix + "scratch."
    for i in range(1, 5):
        out[f"layer{i}_rn"] = conv2d(sd, f"{s}layer{i}_rn")
        rf = f"{s}refinenet{i}"
        block = {
            "resConfUnit2": {
                "conv1": conv2d(sd, rf + ".resConfUnit2.conv1"),
                "conv2": conv2d(sd, rf + ".resConfUnit2.conv2"),
            },
            "out_conv": conv2d(sd, rf + ".out_conv"),
        }
        if i != 4:  # refinenet4's resConfUnit1 is dead weight
            block["resConfUnit1"] = {
                "conv1": conv2d(sd, rf + ".resConfUnit1.conv1"),
                "conv2": conv2d(sd, rf + ".resConfUnit1.conv2"),
            }
        out[f"refinenet{i}"] = block
    out["output_conv1"] = conv2d(sd, s + "output_conv.0")
    out["output_conv2_0"] = conv2d(sd, s + "output_conv.2")
    out["output_conv2_2"] = conv2d(sd, s + "output_conv.4")
    return out


def _zoe_net2(sd, prefix):
    """ZoeDepth _net Sequential (conv,act,conv[,act]) -> conv1/conv2."""
    return {"conv1": conv2d(sd, prefix + "._net.0"),
            "conv2": conv2d(sd, prefix + "._net.2")}


def convert_zoedepth_head(sd, prefix: str = ""):
    """ZoeDepth metric-bins head (released single-domain layout) ->
    nunif_tpu_torch.iw3.depth.zoedepth.MetricBinsHead."""
    p = prefix
    out = {
        "conv2": conv2d(sd, p + "conv2"),
        "seed_bin_regressor": _zoe_net2(sd, p + "seed_bin_regressor"),
        "seed_projector": _zoe_net2(sd, p + "seed_projector"),
        "conditional_log_binomial": {
            "mlp_conv1": conv2d(sd, p + "conditional_log_binomial.mlp.0"),
            "mlp_conv2": conv2d(sd, p + "conditional_log_binomial.mlp.2"),
        },
    }
    for i in range(4):
        out[f"projectors_{i}"] = _zoe_net2(sd, f"{p}projectors.{i}")
        out[f"attractors_{i}"] = _zoe_net2(sd, f"{p}attractors.{i}")
    return out


def convert_zoedepth(sd, backbone: str = "beit_l_384"):
    """Full ZoeDepth (single-domain, e.g. ZoeD_N): MiDaS core nested at
    core.core.* + bins head at the root."""
    return {"core": convert_midas_core(sd, backbone, prefix="core.core."),
            "bin_head": convert_zoedepth_head(sd)}


def convert_da3mono(sd, encoder: str = "vitl"):
    """DA3-mono (da3mono-large.safetensors via hub
    nagadomi/Depth-Anything-3_iw3): DINOv2 trunk + DPT head with a
    2-channel (depth+sky) output conv — the DA v1/v2 layout with a wider
    final conv.  Normalizes common wrapper prefixes first."""
    sd = dict(sd)
    for wrap in ("model.", "module."):
        if any(k.startswith(wrap) for k in sd) and \
                not any(k.startswith("pretrained.") for k in sd):
            sd = {k[len(wrap):] if k.startswith(wrap) else k: v
                  for k, v in sd.items()}
    alias = {"backbone.": "pretrained.", "encoder.": "pretrained.",
             "head.": "depth_head."}
    if not any(k.startswith("pretrained.") for k in sd):
        sd = {next((new + k[len(old):] for old, new in alias.items()
                    if k.startswith(old)), k): v for k, v in sd.items()}
    return convert_depth_anything(sd, encoder)


def convert_depth_pro(sd, encoder: str = "vitl"):
    """Map the Apple DepthPro checkpoint (depth_pro.pt via hub
    nagadomi/ml-depth-pro_iw3) to nunif_tpu_torch.iw3.depth.depth_pro.DepthPro.

    Layout: encoder.{patch,image}_encoder + fov.encoder.0 are timm DINOv2
    ViTs; encoder.upsample* project+upsample Sequentials; decoder.convs /
    decoder.fusions (FeatureFusionBlock2d with ResidualBlock pairs);
    head.{0,1,2,4}; fov.{encoder.1,downsample.0,head.{0,2,4}}."""
    from ..iw3.depth.dinov2 import VIT_CONFIGS
    depth = VIT_CONFIGS[encoder]["depth"]
    sd = {k[6:] if k.startswith("model.") else k: v for k, v in sd.items()}

    def up_block(prefix, n_up):
        out = {"proj": conv2d(sd, prefix + ".0")}
        for i in range(n_up):
            out[f"up{i}"] = conv_transpose2d(sd, f"{prefix}.{i + 1}")
        return out

    def res_block(prefix):
        return {"conv1": conv2d(sd, prefix + ".residual.1"),
                "conv2": conv2d(sd, prefix + ".residual.3")}

    def fusion(i):
        out = {"resnet2": res_block(f"decoder.fusions.{i}.resnet2"),
               "out_conv": conv2d(sd, f"decoder.fusions.{i}.out_conv")}
        if i != 4:
            # fusions[4] (global) is called with a single input; its
            # resnet1 params are dead weights never instantiated in flax
            out["resnet1"] = res_block(f"decoder.fusions.{i}.resnet1")
        if i != 0:
            out["deconv"] = conv_transpose2d(sd, f"decoder.fusions.{i}.deconv")
        return out

    params = {
        "patch_encoder": dino_vit(sd, "encoder.patch_encoder", depth),
        "image_encoder": dino_vit(sd, "encoder.image_encoder", depth),
        "upsample_latent0": up_block("encoder.upsample_latent0", 3),
        "upsample_latent1": up_block("encoder.upsample_latent1", 2),
        "upsample0": up_block("encoder.upsample0", 1),
        "upsample1": up_block("encoder.upsample1", 1),
        "upsample2": up_block("encoder.upsample2", 1),
        "upsample_lowres": conv_transpose2d(sd, "encoder.upsample_lowres"),
        "fuse_lowres": conv2d(sd, "encoder.fuse_lowres"),
        "head_conv0": conv2d(sd, "head.0"),
        "head_up1": conv_transpose2d(sd, "head.1"),
        "head_conv2": conv2d(sd, "head.2"),
        "head_conv4": conv2d(sd, "head.4"),
    }
    for i in range(1, 5):
        params[f"conv{i}"] = conv2d(sd, f"decoder.convs.{i}")
    for i in range(5):
        params[f"fusion{i}"] = fusion(i)
    if "fov.encoder.1.weight" in sd:
        params["fov_encoder"] = dino_vit(sd, "fov.encoder.0", depth)
        params["fov_proj"] = linear(sd, "fov.encoder.1")
        params["fov_downsample"] = conv2d(sd, "fov.downsample.0")
        params["fov_head0"] = conv2d(sd, "fov.head.0")
        params["fov_head2"] = conv2d(sd, "fov.head.2")
        params["fov_head4"] = conv2d(sd, "fov.head.4")
    return params


def conv_bn_fused(sd, conv_prefix, bn_prefix, eps: float = 1e-5):
    """A conv followed by an eval-mode BatchNorm, folded into one conv
    (HWIO kernel)."""
    w = _np(sd[conv_prefix + ".weight"])
    b = _np(sd[conv_prefix + ".bias"]) if conv_prefix + ".bias" in sd \
        else np.zeros(w.shape[0], np.float32)
    gamma, beta = _np(sd[bn_prefix + ".weight"]), _np(sd[bn_prefix + ".bias"])
    mean, var = _np(sd[bn_prefix + ".running_mean"]), _np(sd[bn_prefix + ".running_var"])
    scale = gamma / np.sqrt(var + eps)
    return {"kernel": (w * scale[:, None, None, None]).transpose(2, 3, 1, 0).astype(np.float32),
            "bias": ((b - mean) * scale + beta).astype(np.float32)}


def _rebnconv(sd, prefix):
    return conv_bn_fused(sd, prefix + ".conv_s1", prefix + ".bn_s1")


def _rsu(sd, prefix, height, flat=False):
    """An RSU block of ``height`` (``flat``: RSU4F, rebnconv1-4 and
    3d-1d)."""
    down = range(1, 5) if flat else range(1, height + 1)
    up = range(3, 0, -1) if flat else range(height - 1, 0, -1)
    out = {"rebnconvin": _rebnconv(sd, prefix + ".rebnconvin")}
    out.update({f"rebnconv{i}": _rebnconv(sd, f"{prefix}.rebnconv{i}") for i in down})
    out.update({f"rebnconv{i}d": _rebnconv(sd, f"{prefix}.rebnconv{i}d") for i in up})
    return out


def convert_u2netp(sd, prefix: str = ""):
    """U2-Net-p (BatchNorm folded into each conv); ``prefix`` "u2netp."
    for an ``iw3.sod_v1`` checkpoint, which nests the net there."""
    heights = {"stage1": 7, "stage2": 6, "stage3": 5, "stage4": 4,
               "stage4d": 4, "stage3d": 5, "stage2d": 6, "stage1d": 7}
    out = {name: _rsu(sd, prefix + name, h) for name, h in heights.items()}
    out.update({name: _rsu(sd, prefix + name, 4, flat=True)
                for name in ("stage5", "stage6", "stage5d")})
    out.update({f"side{i}": conv2d(sd, prefix + f"side{i}") for i in range(1, 7)})
    out["outconv"] = conv2d(sd, prefix + "outconv")
    return out


def _wa_block(sd, prefix):
    """iw3's WABlock (row_flow_v3, MLBW, DepthAA)."""
    return {"mha": {"qkv_proj": linear(sd, prefix + ".mha.mha.qkv_proj"),
                    "head_proj": linear(sd, prefix + ".mha.mha.head_proj")},
            "bias": {"to_bias_0": linear(sd, prefix + ".bias.to_bias.0"),
                     "to_bias_2": linear(sd, prefix + ".bias.to_bias.2")},
            "conv_mlp_0": conv2d(sd, prefix + ".conv_mlp.0"),
            "conv_mlp_3": conv2d(sd, prefix + ".conv_mlp.3")}


def convert_da3mono_disparity(sd):
    """The reference's 3-layer MLP ``mlp.0`` / ``mlp.2`` / ``mlp.4``."""
    return {"mlp_0": linear(sd, "mlp.0"),
            "mlp_2": linear(sd, "mlp.2"),
            "mlp_4": linear(sd, "mlp.4")}


def convert_depth_aa(sd):
    return {"proj_in": conv2d(sd, "proj_in"),
            **{f"blocks_{i}": _wa_block(sd, f"blocks.{i}") for i in range(3)},
            "proj_out": conv2d(sd, "proj_out")}


def convert_row_flow_v2(sd):
    return {"feature_0": conv2d(sd, "feature.0"),
            "non_overlap": conv2d(sd, "non_overlap"),
            **{f"overlap_residual_{i}": conv2d(sd, f"overlap_residual.{i}")
               for i in (0, 2, 4, 6)}}


def convert_row_flow_v3(sd):
    return {"blocks_0": conv2d(sd, "blocks.0"),
            "blocks_1": _wa_block(sd, "blocks.1"),
            "blocks_2": _wa_block(sd, "blocks.2"),
            "last_layer_1": conv2d(sd, "last_layer.1")}


def convert_mlbw(sd, small: bool = False):
    """MLBW and its variants (l2 / l4 / l2s / l4s / the mask net): the
    variant changes channel counts, not the key layout."""
    return {"lv1_in_1": conv2d(sd, "lv1_in.1"),
            "lv1_out_1": conv2d(sd, "lv1_out.1"),
            **{f"lv2_{i}": _wa_block(sd, f"lv2.{i}")
               for i in range(2 if small else 4)}}


def _gmlp_inner(sd, prefix):
    """GMLP: ``proj_spatial`` is a Conv1d whose (out, in, 1) kernel keeps
    its first two axes."""
    return {"proj_in": linear(sd, prefix + ".proj_in"),
            "proj_spatial_kernel": _np(sd[prefix + ".proj_spatial.weight"])[:, :, 0],
            "proj_spatial_bias": _np(sd[prefix + ".proj_spatial.bias"]),
            "proj_out": linear(sd, prefix + ".proj_out")}


def _gmlp_block(sd, prefix):
    """The inpaint nets' GMLPBlock / GMLP3DBlock."""
    return {"gmlp": {"gmlp": _gmlp_inner(sd, prefix + ".gmlp.gmlp")},
            "norm1": {"LayerNorm_0": layer_norm(sd, prefix + ".norm1")},
            "norm2": {"LayerNorm_0": layer_norm(sd, prefix + ".norm2")},
            "glu_conv": {"w1": conv2d(sd, prefix + ".glu_conv.w1"),
                         "w2": conv2d(sd, prefix + ".glu_conv.w2")}}


def convert_light_inpaint_v1(sd):
    return {"mask_bias": _np(sd["mask_bias"]).transpose(0, 2, 3, 1),
            "patch_0": conv2d(sd, "patch.0"),
            "enc1": _gmlp_block(sd, "enc1"),
            "down": conv2d(sd, "down"),
            **{f"enc2_{i}": _gmlp_block(sd, f"enc2.{i}") for i in range(4)},
            "up": conv2d(sd, "up"),
            "dec1": _gmlp_block(sd, "dec1"),
            "to_image_1": conv2d(sd, "to_image.1")}


def convert_light_video_inpaint_v1(sd):
    return {"mask_bias": _np(sd["mask_bias"]).transpose(0, 2, 3, 1),
            "patch": conv2d(sd, "patch"),
            "enc1": _gmlp_block(sd, "enc1"),
            "down": conv2d(sd, "down"),
            **{f"enc2_{i}": _gmlp_block(sd, f"enc2.{i}") for i in range(5)},
            "up": conv2d(sd, "up"),
            "dec1": _gmlp_block(sd, "dec1"),
            "to_image": conv2d(sd, "to_image")}


def _cliqa_res(sd, prefix):
    """ResBlockBNReLU, identity shortcut: conv.0 + conv.1 (BN), conv.3 +
    conv.4 (BN)."""
    return {"conv1": conv_bn_fused(sd, prefix + ".conv.0", prefix + ".conv.1"),
            "conv2": conv_bn_fused(sd, prefix + ".conv.3", prefix + ".conv.4")}


def _cliqa_head(sd, prefix):
    return {"conv": conv_bn_fused(sd, prefix + ".0", prefix + ".1"),
            "out": conv2d(sd, prefix + ".4")}


def convert_cliqa(sd, heads):
    """A cliqa predictor's shared trunk and its named ``heads`` (e.g.
    ["quality_output", "subsampling_output"]), BatchNorm folded in: for a
    model built with ``norm="none"``."""
    out = {"features": {
        "conv0": conv_bn_fused(sd, "features.0", "features.1"),
        "conv1": conv_bn_fused(sd, "features.3", "features.4"),
        "res1": _cliqa_res(sd, "features.7"),
        "res2": _cliqa_res(sd, "features.9")}}
    out.update({h: _cliqa_head(sd, h) for h in heads})
    return out


def _outpaint_mha_block(sd, prefix):
    """stlizer's MHABlock."""
    return {"mha": {"qkv_proj": linear(sd, prefix + ".mha.mha.qkv_proj"),
                    "head_proj": linear(sd, prefix + ".mha.mha.head_proj")},
            "bias": {"to_bias_0": linear(sd, prefix + ".bias.to_bias.0"),
                     "to_bias_2": linear(sd, prefix + ".bias.to_bias.2")},
            "mlp_0": conv2d(sd, prefix + ".mlp.0"),
            "mlp_2": conv2d(sd, prefix + ".mlp.2")}


def _outpaint_pool_block(sd, prefix):
    """stlizer's PoolBlock."""
    return {f"mlp_{i}": conv2d(sd, f"{prefix}.mlp.{i}") for i in (0, 3, 5)}


def convert_light_outpaint_v1(sd):
    m, p = _outpaint_mha_block, _outpaint_pool_block
    return {"net": {
        "dct_0": conv2d(sd, "net.dct.blocks.1"),
        "dct_1": conv2d(sd, "net.dct.blocks.4"),
        "dct_2": conv2d(sd, "net.dct.blocks.7"),
        "enc_mha": m(sd, "net.enc_block.0"), "enc_pool": p(sd, "net.enc_block.1"),
        "proj_mid": conv2d(sd, "net.proj_mid"),
        "mid_mha1": m(sd, "net.mid_block.0"), "mid_pool1": p(sd, "net.mid_block.1"),
        "mid_mha2": m(sd, "net.mid_block.2"), "mid_pool2": p(sd, "net.mid_block.3"),
        "proj_out": conv2d(sd, "net.proj_out"),
        "dec_mha": m(sd, "net.dec_block.0"), "dec_pool": p(sd, "net.dec_block.1"),
        "to_image": conv2d(sd, "net.to_image_biliner.proj")}}


def convert_upconv7(sd):
    """waifu2x upconv_7: ``net.{0,2,...,10}`` 3x3 convs -> ``Conv_0`` ..
    ``Conv_5``; ``net.12``, ``ConvTranspose2d(256, out, 4, 2, 3)``, ->
    ``ConvTranspose2dTorch_0``, whose kernel is the forward conv's over the
    dilated input: (kh, kw, I, O) flipped in space."""
    out = {f"Conv_{i}": conv2d(sd, f"net.{t}")
           for i, t in enumerate((0, 2, 4, 6, 8, 10))}
    w = _np(sd["net.12.weight"])  # (I, O, kh, kw)
    out["ConvTranspose2dTorch_0"] = {
        "kernel": w.transpose(2, 3, 0, 1)[::-1, ::-1].copy(),
        "bias": _np(sd["net.12.bias"])}
    return out


def convert_vgg7(sd):
    """waifu2x vgg_7: ``net.{0,2,...,12}`` 3x3 convs -> ``Conv_0`` .. ``Conv_6``."""
    return {f"Conv_{i}": conv2d(sd, f"net.{t}")
            for i, t in enumerate((0, 2, 4, 6, 8, 10, 12))}


def convert_swin_unet(sd, base_dim: int = 96, base_layers: int = 2,
                      scale_factor: int = 2):
    """waifu2x swin_unet (torchvision ``SwinTransformerBlock`` V1 inside)
    -> ``waifu2x.swin_unet_*``; the block norms only where the checkpoint
    has them (``layer_norm`` models)."""
    def swin_blocks(prefix, num_layers):
        out = {}
        for i in range(num_layers):
            b = f"{prefix}.block.{i}"
            blk = {"attn": {"qkv": linear(sd, b + ".attn.qkv"),
                            "proj": linear(sd, b + ".attn.proj"),
                            "relative_position_bias_table": raw(
                                sd, b + ".attn.relative_position_bias_table")},
                   "mlp": {"fc1": linear(sd, b + ".mlp.0"),
                           "fc2": linear(sd, b + ".mlp.3")}}
            if b + ".norm1.weight" in sd:
                blk["norm1"] = layer_norm(sd, b + ".norm1")
                blk["norm2"] = layer_norm(sd, b + ".norm2")
            out[f"block{i}"] = blk
        return out

    L = base_layers
    unet = {
        "patch_conv0": conv2d(sd, "unet.patch.0"),
        "patch_conv1": conv2d(sd, "unet.patch.2"),
        "swin1": swin_blocks("unet.swin1", L),
        "down1": {"conv": conv2d(sd, "unet.down1.conv")},
        "swin2": swin_blocks("unet.swin2", L),
        "down2": {"conv": conv2d(sd, "unet.down2.conv")},
        "swin3": swin_blocks("unet.swin3", L * 3),
        "up2": {"proj": linear(sd, "unet.up2.proj")},
        "swin4": swin_blocks("unet.swin4", L),
        "up1": {"proj": linear(sd, "unet.up1.proj")},
        "swin5": swin_blocks("unet.swin5", L),
    }
    if scale_factor in (4, 8):
        unet["proj2"] = linear(sd, "unet.proj2")
    if scale_factor == 8:
        unet["to_image"] = {"proj0": linear(sd, "unet.to_image.proj.0"),
                            "proj1": linear(sd, "unet.to_image.proj.2")}
    else:
        unet["to_image"] = {"proj": linear(sd, "unet.to_image.proj")}
    return {"unet": unet}


def _wac_block(sd, prefix):
    """swin_unet_v2's WACBlock: window MHA, its score-bias MLP, the
    scale-only norm and the conv MLP."""
    return {
        "mha": {"qkv_proj": linear(sd, prefix + ".mha.mha.qkv_proj"),
                "head_proj": linear(sd, prefix + ".mha.mha.head_proj")},
        "relative_bias": {
            "to_bias_0": linear(sd, prefix + ".relative_bias.to_bias.0"),
            "to_bias_2": linear(sd, prefix + ".relative_bias.to_bias.2")},
        "norm": {"LayerNorm_0": layer_norm(sd, prefix + ".norm")},
        "conv_mlp": {"w1": conv2d(sd, prefix + ".conv_mlp.w1"),
                     "w2": conv2d(sd, prefix + ".conv_mlp.w2")},
    }


def _source_residual(sd):
    return {"resampling": _np(
                sd["unet.to_image.resampling.weight"]).transpose(2, 3, 1, 0),
            "scale_bias": _np(sd["unet.to_image.scale_bias"])}


def convert_swin_unet_v2(sd, first_layers: int = 2, last_layers: int = 3):
    """waifu2x swin_unet_v2 (winc_unet) -> ``waifu2x.swin_unet_v2_*``."""
    def wacs(prefix, n):
        return {f"blocks_{i}": _wac_block(sd, f"{prefix}.blocks.{i}")
                for i in range(n)}

    return {"unet": {
        "ir": {"path1_0": conv2d(sd, "unet.ir.path1.0"),
               "path2_1": conv2d(sd, "unet.ir.path2.1"),
               "path2_2": _wac_block(sd, "unet.ir.path2.2"),
               "path2_3": _wac_block(sd, "unet.ir.path2.3")},
        "patch": conv2d(sd, "unet.patch"),
        "wac1": wacs("unet.wac1", first_layers),
        "down1": {"conv": conv2d(sd, "unet.down1.conv")},
        "wac2": wacs("unet.wac2", 4),
        "up1": {"proj": conv2d(sd, "unet.up1.proj")},
        "wac3": wacs("unet.wac3", last_layers),
        "to_residual_image": {
            "proj": conv2d(sd, "unet.to_residual_image.proj")},
        "to_image": _source_residual(sd),
    }}


def _wgmlp_block(sd, prefix):
    """wgmlp's WGMLPBlock: gMLP (its spatial projection a k = 1 Conv1d),
    two scale-only norms, the conv MLP."""
    g = prefix + ".gmlp.gmlp"
    return {
        "gmlp": {"gmlp": {
            "proj_in": linear(sd, g + ".proj_in"),
            "proj_spatial_kernel": _np(sd[g + ".proj_spatial.weight"])[:, :, 0],
            "proj_spatial_bias": _np(sd[g + ".proj_spatial.bias"]),
            "proj_out": linear(sd, g + ".proj_out"),
        }},
        "norm1": {"LayerNorm_0": layer_norm(sd, prefix + ".norm1")},
        "norm2": {"LayerNorm_0": layer_norm(sd, prefix + ".norm2")},
        "conv_mlp": {"w1": conv2d(sd, prefix + ".conv_mlp.w1"),
                     "w2": conv2d(sd, prefix + ".conv_mlp.w2")},
    }


def convert_wgmlp(sd, first_layers: int = 2, last_layers: int = 3):
    """waifu2x wgmlp_4x -> ``waifu2x.wgmlp_4x``."""
    def blocks(prefix, n):
        return {f"blocks_{i}": _wgmlp_block(sd, f"{prefix}.blocks.{i}")
                for i in range(n)}

    overscan = {name: conv2d(sd, f"unet.ir.overscan.{src}") for name, src in (
        ("conv1", "conv1"), ("conv2", "conv2"), ("conv3", "conv3"),
        ("fuse_0", "fuse.0"), ("fuse_2", "fuse.2"))}
    return {"unet": {
        "ir": {"patch": conv2d(sd, "unet.ir.patch"), "overscan": overscan,
               "fusion": conv2d(sd, "unet.ir.fusion")},
        "patch": conv2d(sd, "unet.patch"),
        "wgmlp1": blocks("unet.wgmlp1", first_layers),
        "down1": {"conv": conv2d(sd, "unet.down1.conv")},
        "wgmlp2": blocks("unet.wgmlp2", 4),
        "up1": {"proj": conv2d(sd, "unet.up1.proj")},
        "wgmlp3": blocks("unet.wgmlp3", last_layers),
        "to_residual_image": {
            "proj": conv2d(sd, "unet.to_residual_image.proj")},
        "to_image": _source_residual(sd),
    }}


def _unet_conv(sd, prefix, se):
    out = {"conv_0": conv2d(sd, prefix + ".conv.0"),
           "conv_2": conv2d(sd, prefix + ".conv.2")}
    if se:
        out["seblock"] = {"conv1": conv2d(sd, prefix + ".seblock.conv1"),
                          "conv2": conv2d(sd, prefix + ".seblock.conv2")}
    return out


def convert_cunet(sd, scale: int = 1):
    """waifu2x cunet (``scale`` 1) / upcunet (2) -> ``waifu2x.cunet`` /
    ``waifu2x.upcunet``."""
    unet1 = {
        "conv1": _unet_conv(sd, "unet1.conv1", se=False),
        "conv1_down": conv2d(sd, "unet1.conv1_down"),
        "conv2": _unet_conv(sd, "unet1.conv2", se=True),
        "conv2_up": conv_transpose2d(sd, "unet1.conv2_up"),
        "conv3": conv2d(sd, "unet1.conv3"),
        "conv_bottom": (conv_transpose2d if scale == 2 else conv2d)(
            sd, "unet1.conv_bottom"),
    }
    unet2 = {
        "conv1": _unet_conv(sd, "unet2.conv1", se=False),
        "conv1_down": conv2d(sd, "unet2.conv1_down"),
        "conv2": _unet_conv(sd, "unet2.conv2", se=True),
        "conv2_down": conv2d(sd, "unet2.conv2_down"),
        "conv3": _unet_conv(sd, "unet2.conv3", se=True),
        "conv3_up": conv_transpose2d(sd, "unet2.conv3_up"),
        "conv4": _unet_conv(sd, "unet2.conv4", se=True),
        "conv4_up": conv_transpose2d(sd, "unet2.conv4_up"),
        "conv5": conv2d(sd, "unet2.conv5"),
        "conv_bottom": conv2d(sd, "unet2.conv_bottom"),
    }
    return {"unet1": unet1, "unet2": unet2}


def _bn_params(sd, prefix):
    """torch BatchNorm2d -> FrozenBatchNorm params, running statistics
    kept."""
    return {"scale": _np(sd[_key(prefix, "weight")]),
            "bias": _np(sd[_key(prefix, "bias")]),
            "mean": _np(sd[_key(prefix, "running_mean")]),
            "var": _np(sd[_key(prefix, "running_var")])}


# torchvision vgg11_bn ``features`` indices of the conv / BN pairs
_VGG11_BN_IDX = ((0, 1), (4, 5), (8, 9), (11, 12), (15, 16), (18, 19),
                 (22, 23), (25, 26))


def convert_vgg11_bn(sd, prefix: str = ""):
    """torchvision vgg11_bn -> imagenet.VGG11; the reference checkpoint
    nests it under ``net.`` (pass ``prefix="net"``).  Running BN statistics
    stay FrozenBatchNorm params, not folded into the convs."""
    p = (prefix + ".") if prefix else ""
    out = {}
    for k, (ci, bi) in enumerate(_VGG11_BN_IDX):
        out[f"conv{k}"] = conv2d(sd, f"{p}features.{ci}")
        out[f"bn{k}"] = _bn_params(sd, f"{p}features.{bi}")
    for j, t in enumerate((0, 3, 6)):
        out[f"fc{j}"] = linear(sd, f"{p}classifier.{t}")
    return out


def flatten(tree, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


_VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def convert_vgg16_features(sd, prefix: str = "features"):
    """A torchvision ``vgg16`` state dict's ``features`` trunk -> the tree of
    ``modules.lpips.VGG16Features`` (``conv0`` ... ``conv12``), for LPIPS
    with the reference's VGG weights (load it under ``net`` of ``LPIPS``)."""
    return {f"conv{i}": conv2d(sd, f"{prefix}.{t}")
            for i, t in enumerate(_VGG16_CONV_IDX)}
