"""Depth model base: lifecycle, the EMA min-max normalisation hooks and
the network loader of every family, the DepthAA filter and the 16-bit
depth PNG round trip (counterpart of ``nunif_tpu/iw3/depth/base.py``).

With a lookahead buffer (``buffer_size > 1``) the scaler holds frames back:
``minmax_normalize`` returns fewer frames than it was given and
``flush_minmax_normalize`` the rest.  ``reset`` clears the scaler and any
temporal state of the model (``reset_state``)."""
from __future__ import annotations

import logging
import math
from abc import ABCMeta, abstractmethod

import numpy as np
import torch

from ...core.device import resolve_device
from ..depth_scaler import EMAMinMaxScaler

logger = logging.getLogger("nunif_tpu_torch.iw3")


def load_depth_net(checkpoint, device, cls, build, convert=None, generator=None):
    """A depth wrapper's network on ``device``, in eval mode:
    - a raw upstream checkpoint (``.pth`` / ``.pt`` / ``.safetensors``, by
      suffix) converted by ``convert(state_dict) -> (model, flax tree)``;
    - a ``.nztm`` file, which must hold a ``cls``;
    - without a checkpoint, ``build()`` with flax's init drawn from
      ``generator`` (default: seed 0), and the JAX package's warning."""
    from ...models import from_flax, init_flax_default, load_model
    from ...models.pth_import import is_raw_checkpoint, load_torch_checkpoint
    from ...models.torch_convert import flatten
    if checkpoint is not None and is_raw_checkpoint(checkpoint):
        if convert is None:
            raise ValueError(f"{checkpoint}: {cls.__name__} reads .nztm "
                             "checkpoints only")
        _name, _kwargs, sd = load_torch_checkpoint(checkpoint)
        with torch.device(device):
            model, tree = convert(sd)
        from_flax(model, flatten(tree))
        logger.info("converted %s checkpoint %s", cls.__name__, checkpoint)
    elif checkpoint is not None:
        model, _meta = load_model(checkpoint, device=device)
        if not isinstance(model, cls):
            raise ValueError(f"{checkpoint}: not an {cls.model_name} "
                             f"checkpoint ({type(model).__name__})")
        return model
    else:
        logger.warning("%s: no checkpoint given; random init "
                       "(structure/benchmark use only)", cls.__name__)
        with torch.device(device):  # torch's own init runs where the net will
            model = build()
        init_flax_default(model, generator or torch.Generator().manual_seed(0))
    return model.eval().requires_grad_(False).to(device)


# the heads' output biases under seeded weights (``seeded_weights_``'s
# fills), by model type: positive ReLU maps, a sky map that is not all sky,
# a field of view near 60 degrees (else f_px is far off)
_ZOE_FILLS = {"core/output_conv2_2/bias": [1.0]}
_ZOE_ANY_FILLS = {"core/depth_head/output_conv2_2/bias": [1.0]}
_DA3_FILLS = {"depth_head/output_conv2_2/bias": [0.5, -0.8]}
_PRO_FILLS = {"head_conv4/bias": [1.0], "fov_head4/bias": [60.0]}
SEEDED_FILLS = {"ZoeD_N": _ZOE_FILLS, "ZoeD_K": _ZOE_FILLS, "ZoeD_NK": _ZOE_FILLS,
                "ZoeD_Any_N": _ZOE_ANY_FILLS, "ZoeD_Any_K": _ZOE_ANY_FILLS,
                "Any_V3_Mono": _DA3_FILLS, "Any_V3_Mono_01": _DA3_FILLS,
                "DepthPro": _PRO_FILLS, "DepthPro_S": _PRO_FILLS}


def seeded_leaf(leaf, shape, fan_in, normal):
    """The seeded value of a flax leaf named ``leaf``, from ``normal(shape)``
    (standard normal draws, numpy's or torch's): kernels N(0, 1/fan_in)
    clipped at 2 std, LayerNorm scales 1 + N(0, 0.02), LayerScale gammas
    0.1 (a float), relative-position tables N(0, 0.5) (so the bias moves
    the scores), every other leaf (biases, class tokens, position
    embeddings) N(0, 0.02)."""
    if leaf in ("kernel", "qkv_kernel"):
        return normal(shape).clip(-2.0, 2.0) * (math.sqrt(1.0 / fan_in) / 0.8796256610342398)
    if leaf == "scale":
        return 1.0 + 0.02 * normal(shape)
    if leaf in ("gamma", "gamma_1", "gamma_2"):
        return 0.1
    if leaf == "relative_position_bias_table":
        return 0.5 * normal(shape)
    return 0.02 * normal(shape)


@torch.no_grad()
def seeded_weights_(model, generator, fills=None):
    """Fill ``model`` in place with seeded random weights under which its
    maps are not degenerate: ``seeded_leaf`` by flax leaf name (fan-in of
    the flax layout), drawn from ``generator`` on its own device so that a
    full-width net is filled on the card.  ``fills``: {flax path: value or
    list of values} set afterwards (``SEEDED_FILLS``)."""
    from ...models.flax_params import flax_keys

    def randn(shape):
        return torch.randn(shape, generator=generator, device=generator.device)

    params = dict(model.named_parameters())
    keys = flax_keys(model)
    for name, key in keys.items():
        p = params[name]
        leaf = key.rsplit("/", 1)[-1]
        owner = model.get_submodule(name.rpartition(".")[0])
        # torch layout (out, in, ...): the flax layout's fan-in
        fan_in = (owner.fan_in if hasattr(owner, "fan_in") else
                  p.shape[0] if leaf == "qkv_kernel" else math.prod(p.shape[1:]))
        a = seeded_leaf(leaf, p.shape, fan_in, randn)
        p.copy_(a) if torch.is_tensor(a) else p.fill_(a)
    for key, value in (fills or {}).items():
        name = next(n for n, k in keys.items() if k == key)
        params[name].copy_(torch.as_tensor(value, dtype=torch.float32))
    return model


class BaseDepthModel(metaclass=ABCMeta):
    def __init__(self, model_type, device="cuda", dtype=torch.bfloat16):
        self.model = None
        self.model_type = model_type
        self.device = resolve_device(device)
        self.dtype = dtype  # the network's compute dtype
        self.scaler = self.create_depth_scaler()
        self.limit_resolution = False
        self._depth_aa = None

    def create_depth_scaler(self):
        return EMAMinMaxScaler(decay=0, buffer_size=1)

    def loaded(self):
        return self.model is not None

    @classmethod
    @abstractmethod
    def get_name(cls):
        ...

    @classmethod
    @abstractmethod
    def supported(cls, model_type):
        ...

    @abstractmethod
    def is_metric(self):
        ...

    def is_image_supported(self):
        return True

    def is_video_supported(self):
        return True

    @abstractmethod
    def load_model(self, model_type, resolution=None, **kwargs):
        ...

    def load(self, resolution=None, limit_resolution=False, **kwargs):
        self.limit_resolution = limit_resolution
        self.model = self.load_model(self.model_type, resolution=resolution,
                                     **kwargs)
        return self

    @abstractmethod
    def infer(self, x, **kwargs):
        ...

    # DepthAA post-filter (--depth-aa)
    def set_depth_aa(self, model):
        """Filter every depth map this model infers through the
        ``iw3.depth_aa`` net ``model`` (None turns it off).  Every wrapper
        with the hook applies it: Depth-Anything, DA3 mono and VDA."""
        self._depth_aa = model

    def apply_depth_aa(self, depth):
        if self._depth_aa is None:
            return depth
        from ..models.depth_aa import depth_aa_infer
        return depth_aa_infer(self._depth_aa, depth)

    # EMA normalisation hooks
    def enable_ema(self, decay, buffer_size=None):
        self.scaler.reset(decay=decay, buffer_size=buffer_size)

    def get_ema_state(self):
        return self.scaler.decay, self.scaler.buffer_size

    def disable_ema(self):
        self.scaler.reset(decay=0, buffer_size=1)

    def reset_ema(self, decay=None, buffer_size=None):
        self.scaler.reset(decay=decay, buffer_size=buffer_size)

    def reset_state(self):
        """Clear the model's temporal state (none here)."""

    def reset(self):
        self.reset_ema()
        self.reset_state()

    def get_ema_buffer_size(self):
        return self.scaler.buffer_size

    def minmax_normalize(self, depth, reset_ema=None):
        """depth (B, H, W, 1) -> list of normalised frames; one
        device-to-host read for the batch."""
        if depth.dim() != 4:
            raise ValueError(f"depth must be (B, H, W, 1), got {tuple(depth.shape)}")
        if reset_ema is not None and len(reset_ema) != depth.shape[0]:
            raise ValueError("reset_ema needs one flag per frame")
        return self.scaler.update_batch(depth, reset_flags=reset_ema)

    def flush_minmax_normalize(self, return_minmax=False):
        """The frames the lookahead buffer still holds, normalised."""
        return self.scaler.flush(return_minmax=return_minmax)

    # 16-bit depth PNG round trip
    @staticmethod
    def save_normalized_depth(depth, file_path, png_info=None,
                              min_depth_value=None, max_depth_value=None):
        """Write depth (H, W) or (H, W, 1) in [0, 1] as a 16-bit gray PNG
        (truncated to 0..65535), with ``iw3_min_depth_value`` /
        ``iw3_max_depth_value`` and ``png_info`` as text chunks."""
        from PIL import Image
        from PIL.PngImagePlugin import PngInfo
        png_info = dict(png_info or {})
        if min_depth_value is not None:
            png_info["iw3_min_depth_value"] = float(min_depth_value)
        if max_depth_value is not None:
            png_info["iw3_max_depth_value"] = float(max_depth_value)
        if torch.is_tensor(depth):
            depth = depth.float().cpu().numpy()
        depth = np.clip(np.asarray(depth, np.float32), 0, 1)
        if depth.ndim == 3:
            depth = depth[..., 0]
        metadata = PngInfo()
        for k, v in png_info.items():
            metadata.add_text(k, str(v))
        Image.fromarray((depth * 0xFFFF).astype(np.uint16)).save(
            file_path, pnginfo=metadata)

    @staticmethod
    def load_depth(file_path):
        """(depth (H, W, 1) fp32 tensor on the CPU, text metadata with
        ``filename``): 16-bit samples / 65535 (8-bit / 255), mapped back
        to [min, max] when the PNG holds both values."""
        from PIL import Image
        with Image.open(file_path) as im:
            text = dict(getattr(im, "text", {}) or {})
            arr = np.asarray(im)
        min_v = max_v = None
        try:
            min_v = float(text["iw3_min_depth_value"])
            max_v = float(text["iw3_max_depth_value"])
        except (KeyError, ValueError, TypeError):
            min_v = max_v = None
        if arr.dtype == np.uint16:
            depth = np.clip(arr.astype(np.float32) / 0xFFFF, 0, 1)
        elif arr.dtype == np.uint8:
            depth = arr.astype(np.float32) / 255.0
        else:
            depth = arr.astype(np.float32)
        if depth.ndim == 3:
            depth = depth.mean(axis=-1)
        depth = depth[..., None]
        if min_v is not None and max_v is not None:
            depth = depth * (max_v - min_v) + min_v
        text["filename"] = file_path
        return torch.from_numpy(np.ascontiguousarray(depth, np.float32)), text
