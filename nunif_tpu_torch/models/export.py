"""Model export as ``torch.export`` programs (counterpart of
``nunif_tpu/models/export.py``, which writes ``jax.export`` StableHLO).

The exported program is the model's forward at one static input bucket
(batch, tile, tile, C), as the JAX package's ``.nzhlo``: fp32 in, cast to
the compute dtype (bf16 by default, the port's policy), the model, fp32
out.  The hand kernels are ``torch.library`` custom ops
(``torch.ops.nunif_tpu_torch.*``: K1 ``fused_swin_block_image``, K2
``stem_conv3x3``, K4 ``fused_window_attention``, K5 ``fused_swin_block``,
K6 ``fused_window_attention_image``, K7 ``sdpa``), so the graph holds
the kernel ops and not their twins: on the card the program launches the
hand kernels, on the CPU the twins.  K3 is not a custom op (no I2I model
reaches it: the stereo warp runs outside the exported models); its
wrapper raises under ``torch.export``.

On the card the program reads each layer's weights in its kernel's
layout (``kernel_layouts``: K1's packed block weights, K2's packed stem,
the window attention's gathered bias), as the eager layers cache them, and
does not pack them on every call.  Baked, they are constants of the
program; otherwise ``layouts.pt2`` makes them from the parameters once,
when the artifact is loaded.

Artifact layout (``.pt2`` file = zip):
  program.pt2   ``torch.export.save`` of the program
  meta.json     {nunif_tpu_export: 1, name, kwargs, input_shape, baked,
                 compute_dtype, device}
  params.npz    the parameters by torch name and layout, unless baked into
                the program; the program then takes them and their kernel
                layouts as its first argument (a dict), so weights change
                without a new export
  layouts.pt2   unbaked on the card: the program that makes the kernel
                layouts from the parameters

``ExportedModel`` loads and calls an artifact without the model's Python
classes: importing this module registers the kernel ops.
"""
from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import zipfile

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..ops import _build
from ..ops import conv3x3 as _k2, swin_attention as _k1  # noqa: F401  (the kernel ops)
from .io import _jsonable
from .model import model_kwargs

logger = logging.getLogger("nunif_tpu_torch.models")

FORMAT_KEY = "nunif_tpu_export"
PROGRAM_ENTRY = "program.pt2"
LAYOUTS_ENTRY = "layouts.pt2"


class _Baked(nn.Module):
    """x fp32 -> model(x in the compute dtype) as fp32; the weights are
    the program's own."""

    def __init__(self, model, compute_dtype):
        super().__init__()
        self.model = model
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return self.model(x.to(self.compute_dtype)).float()


class _WithParams(nn.Module):
    """``_Baked`` with the weights (and on the card their kernel layouts)
    as the first argument, {torch name: tensor}; the model is not a
    submodule, so the program holds none of its weights."""

    def __init__(self, model, compute_dtype):
        super().__init__()
        self.__dict__["model"] = model
        self.compute_dtype = compute_dtype

    def forward(self, params, x):
        return torch.func.functional_call(
            self.model, params, (x.to(self.compute_dtype),)).float()


class _LayoutsOf(nn.Module):
    def __init__(self, model, compute_dtype):
        super().__init__()
        self.model = model
        self.compute_dtype = compute_dtype

    def forward(self):
        return kernel_layouts(self.model, self.compute_dtype)


class _Layouts(nn.Module):
    """The weights {torch name: tensor} -> their ``kernel_layouts``."""

    def __init__(self, model, compute_dtype):
        super().__init__()
        self.__dict__["fn"] = _LayoutsOf(model, compute_dtype)

    def forward(self, params):
        return torch.func.functional_call(
            self.fn, {f"model.{k}": v for k, v in params.items()}, ())


def kernel_layouts(model, dtype) -> dict:
    """{buffer name: tensor}: each layer's weights in its kernel's layout
    for x of ``dtype`` (the layers' ``kernel_layout``), named as
    ``_frozen_layouts`` registers them."""
    return {f"{name}.{_build.LAYOUT_BUFFER}{i}": t
            for name, m in model.named_modules() if hasattr(m, "kernel_layout")
            for i, t in enumerate(m.kernel_layout(dtype))}


@contextlib.contextmanager
def _frozen_layouts(model, layouts):
    """Register ``layouts`` on their layers as buffers for a trace: the
    layers read them (``_build.frozen_layout``) in place of packing."""
    owners = [(model.get_submodule(k.rsplit(".", 1)[0]), k.rsplit(".", 1)[1])
              for k in layouts]
    for (owner, name), t in zip(owners, layouts.values()):
        owner.register_buffer(name, t, persistent=False)
    try:
        yield
    finally:
        for owner, name in owners:
            delattr(owner, name)


def _saved(program) -> bytes:
    # the example inputs (the weights too, when they are an argument) are
    # not part of the program
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def _write(path, program, meta, params=None, layouts=None):
    directory = os.path.dirname(str(path))
    if directory:
        os.makedirs(directory, exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(PROGRAM_ENTRY, _saved(program))
        if layouts is not None:
            z.writestr(LAYOUTS_ENTRY, _saved(layouts))
        z.writestr("meta.json", json.dumps(meta))
        if params is not None:
            pbuf = io.BytesIO()
            np.savez(pbuf, **params)
            z.writestr("params.npz", pbuf.getvalue())
    return path


def kernel_ops(program) -> list:
    """The ``nunif_tpu_torch`` custom ops the exported program calls, by
    name, one entry a call."""
    return [str(n.target).split(".")[1] for n in program.graph.nodes
            if n.op == "call_function"
            and str(n.target).startswith("nunif_tpu_torch.")]


def export_model(model, path, input_shape, bake_params=False,
                 compute_dtype=torch.bfloat16):
    """Export ``model`` (an I2I model on its device) at the static NHWC
    ``input_shape``, e.g. (batch, tile, tile, 3), to ``path``.

    bake_params: the weights live in the program (one self-contained
    file); otherwise they ship as ``params.npz`` and are the program's
    first argument.  Returns the ``torch.export.ExportedProgram``."""
    device = next(model.parameters()).device
    model = model.eval()
    x = torch.zeros(tuple(input_shape), dtype=torch.float32, device=device)
    layouts_program = None
    with torch.no_grad():
        # the CPU twins read the plain weights
        layouts = kernel_layouts(model, compute_dtype) \
            if device.type == "cuda" else {}
        if bake_params:
            with _frozen_layouts(model, layouts):
                program = torch.export.export(_Baked(model, compute_dtype), (x,))
            params = None
        else:
            weights = {k: p.detach() for k, p in model.named_parameters()}
            with _frozen_layouts(model, layouts):
                program = torch.export.export(
                    _WithParams(model, compute_dtype), ({**weights, **layouts}, x))
            if layouts:
                layouts_program = torch.export.export(
                    _Layouts(model, compute_dtype), (weights,))
            params = {k: p.float().cpu().numpy() for k, p in weights.items()}
    meta = {
        FORMAT_KEY: 1,
        "name": model.model_name,
        "kwargs": _jsonable(model_kwargs(model)),
        "input_shape": list(input_shape),
        "baked": bool(bake_params),
        "compute_dtype": str(compute_dtype).split(".")[1],
        "device": device.type,
    }
    _write(path, program, meta, params, layouts_program)
    logger.info("exported %s -> %s (input %s, kernel ops %s)",
                model.model_name, path, tuple(input_shape),
                sorted(set(kernel_ops(program))))
    return program


class ExportedModel:
    """Load and call an exported artifact without the model's Python
    classes, on the device it was exported on."""

    def __init__(self, path):
        with zipfile.ZipFile(path, "r") as z:
            self.meta = json.loads(z.read("meta.json"))
            if self.meta.get(FORMAT_KEY) != 1:
                raise ValueError(f"{path}: not a nunif_tpu_torch export")
            self.device = resolve_device(self.meta["device"])
            self.exported = torch.export.load(io.BytesIO(z.read(PROGRAM_ENTRY)))
            self.params = None
            if not self.meta["baked"]:
                flat = np.load(io.BytesIO(z.read("params.npz")))
                self.params = {k: torch.from_numpy(flat[k]).to(self.device)
                               for k in flat.files}
                if LAYOUTS_ENTRY in z.namelist():
                    layouts = torch.export.load(
                        io.BytesIO(z.read(LAYOUTS_ENTRY))).module()
                    with torch.no_grad():
                        self.params.update(layouts(self.params))
        self.program = self.exported.module()
        # the program would check every tensor of its arguments on every
        # call, an unbaked model's weights and kernel layouts too; they are
        # this object's own, so __call__ checks the inputs' shapes alone
        self.program.validate_inputs = False
        shapes = self.meta["input_shape"]
        self._shapes = [list(s) for s in shapes] \
            if isinstance(shapes[0], list) else [list(shapes)]

    @property
    def input_shape(self):
        return tuple(self.meta["input_shape"])

    def __call__(self, *xs):
        xs = [(x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.array(x, np.float32))).to(self.device, torch.float32)
              for x in xs]
        if [list(x.shape) for x in xs] != self._shapes:
            raise ValueError(f"inputs of shapes {[list(x.shape) for x in xs]}; "
                             f"the program takes {self._shapes}")
        with torch.no_grad():
            if self.params is None:
                return self.program(*xs)
            return self.program(self.params, *xs)


class _Fn(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *xs):
        return self.fn(*xs)


def _export_fn(fn, examples, path, name, extra_meta=None):
    """Export a plain tensor function at its example inputs."""
    with torch.no_grad():
        program = torch.export.export(_Fn(fn), tuple(examples))
    meta = {FORMAT_KEY: 1, "name": name,
            "input_shape": [list(e.shape) for e in examples], "baked": True,
            "device": examples[0].device.type}
    meta.update(extra_meta or {})
    _write(path, program, meta)
    logger.info("exported helper op %s -> %s", name, path)
    return path


def export_helper_ops(out_dir, tile_size=256, channels=3, scale=2,
                      offset=16, blend_size=8, pad=16, device="cuda"):
    """Export the inference helper ops as programs (the JAX package's seven,
    reference nunif/models/onnx_helper_models.py:14-305): reflection pad,
    alpha border pad, 8-way TTA split and merge, the seam-blend filter,
    antialias and the bicubic 2x resize.  Returns {name: path}."""
    import torch.nn.functional as F

    from ..modules.resize import resize
    from ..transforms.tta import tta_merge, tta_split
    from ..utils.alpha import alpha_border_pad
    from ..utils.tiling import make_blend_filter

    os.makedirs(out_dir, exist_ok=True)
    dev = resolve_device(device)
    t = int(tile_size)
    img = torch.zeros((1, t, t, channels), device=dev)
    a1 = torch.zeros((1, t, t, 1), device=dev)
    blend = torch.from_numpy(np.ascontiguousarray(
        make_blend_filter(scale, offset, t, blend_size))).to(dev)
    specs = {
        "pad": (lambda x: F.pad(x.permute(0, 3, 1, 2), (pad,) * 4,
                                mode="reflect").permute(0, 2, 3, 1),
                [img], "helper.reflection_pad", {"pad": pad}),
        "alpha_border_pad": (
            lambda rgb, alpha: alpha_border_pad(rgb[0], alpha[0], offset)[None],
            [img, a1], "helper.alpha_border_padding", {"offset": offset}),
        "tta_split": (lambda x: torch.stack(tta_split(x[0]))[:, None],
                      [img], "helper.tta_split", None),
        "tta_merge": (lambda xs: tta_merge(tuple(xs[i, 0] for i in range(8)))[None],
                      [torch.zeros((8, 1, t, t, channels), device=dev)],
                      "helper.tta_merge", None),
        "seam_blend_filter": (
            lambda dummy: blend[None, ..., None] * torch.ones_like(
                dummy[:, :1, :1, :1]),
            [torch.zeros((1, 1, 1, 1), device=dev)],
            "helper.create_seam_blending_filter",
            {"scale": scale, "offset": offset, "blend_size": blend_size}),
        "antialias": (lambda x: resize(resize(x, t * 2, t * 2, mode="bicubic",
                                              antialias=True),
                                       t, t, mode="bicubic", antialias=True),
                      [img], "helper.antialias", None),
        "bicubic_2x": (lambda x: resize(x, t * 2, t * 2, mode="bicubic",
                                        antialias=False),
                       [img], "helper.resize_bicubic", {"scale": 2}),
    }
    return {key: _export_fn(fn, examples,
                            os.path.join(out_dir, f"{key}.pt2"), name, extra)
            for key, (fn, examples, name, extra) in specs.items()}
