"""Depth -> disparity mapper curves (counterpart of
``nunif_tpu/iw3/mapper.py``): the softplus, distance-to-disparity and
shift-relative-depth families and their named parameter tables.
Elementwise torch on the depth map.
"""
from __future__ import annotations

import math

import torch


def softplus01_legacy(depth, c: float = 6.0):
    min_v = math.log(1 + math.exp(0 * 12.0 - c)) / (12 - c)
    max_v = math.log(1 + math.exp(1 * 12.0 - c)) / (12 - c)
    v = torch.log1p(torch.exp(depth * 12.0 - c)) / (12 - c)
    return (v - min_v) / (max_v - min_v)


def softplus01(x, bias: float, scale: float):
    min_v = math.log(1 + math.exp((0 - bias) * scale))
    max_v = math.log(1 + math.exp((1 - bias) * scale))
    v = torch.log1p(torch.exp((x - bias) * scale))
    return (v - min_v) / (max_v - min_v)


def inv_softplus01(x, bias: float, scale: float):
    min_v = math.log(max(math.expm1((0 - bias) * scale), 1e-6))
    max_v = math.log(max(math.expm1((1 - bias) * scale), 1e-6))
    v = torch.log(torch.clamp(torch.expm1((x - bias) * scale), min=1e-6))
    return (v - min_v) / (max_v - min_v)


def distance_to_disparity(x, c: float):
    c1 = 1.0 + c
    min_v = c / c1
    return ((c / (c1 - x)) - min_v) / (1.0 - min_v)


def inv_distance_to_disparity(x, c: float):
    return ((c + 1) * x) / (x + c)


def shift_relative_depth(x, min_distance: float, max_distance: float = 16.0):
    provisional_max_distance = min_distance + max_distance
    A = 1.0 / provisional_max_distance
    B = (1.0 / min_distance) - (1.0 / provisional_max_distance)
    distance = 1.0 / (A + B * x)
    distance = (1.0 - min_distance) + distance
    new_x = 1.0 / distance
    min_value = 1.0 / (max_distance + 1)
    value_range = 1.0 - 1.0 / (max_distance + 1)
    return (new_x - min_value) / value_range


_MUL_PARAMS = {
    "mul_1": {"bias": 0.343, "scale": 12},
    "mul_2": {"bias": 0.515, "scale": 12},
    "mul_3": {"bias": 0.687, "scale": 12},
}
_INV_MUL_PARAMS = {
    "inv_mul_1": {"bias": -0.002102, "scale": 7.8788},
    "inv_mul_2": {"bias": -0.0003, "scale": 6.2626},
    "inv_mul_3": {"bias": -0.0001, "scale": 3.4343},
}
_SHIFT_PARAMS = {
    "shift_30": 3.0, "shift_20": 2.0, "shift_14": 1.4,
    "shift_08": 0.8, "shift_06": 0.6, "shift_045": 0.45,
}
_DIV_PARAMS = {
    "div_25": 2.5, "div_10": 1.0, "div_6": 0.6,
    "div_4": 0.4, "div_2": 0.2, "div_1": 0.1,
}


def resolve_mapper_function(name: str):
    if name == "pow2":
        return lambda x: x ** 2
    if name == "none":
        return lambda x: x
    if name == "softplus":
        return softplus01_legacy
    if name == "softplus2":
        return lambda x: softplus01_legacy(x) ** 2
    if name in _MUL_PARAMS:
        p = _MUL_PARAMS[name]
        return lambda x: softplus01(x, **p)
    if name in _INV_MUL_PARAMS:
        p = _INV_MUL_PARAMS[name]
        return lambda x: inv_softplus01(x, **p)
    if name in _SHIFT_PARAMS:
        d = _SHIFT_PARAMS[name]
        return lambda x: shift_relative_depth(x, d)
    if name in _DIV_PARAMS:
        c = _DIV_PARAMS[name]
        return lambda x: distance_to_disparity(x, c)
    raise NotImplementedError(f"mapper={name}")


def get_mapper(name: str):
    """Compose mappers: ``a:b`` chains, ``a+b=w`` interpolates."""
    names = name.split(":") if ":" in name else [name]
    functions = []
    for n in names:
        if "+" in n:
            n, _, weight = n.partition("=")
            weight = float(weight) if weight else 0.5
            if not 0.0 <= weight <= 1.0:
                raise ValueError(f"mapper weight {weight} outside [0, 1]")
            a_name, b_name = n.split("+")
            fa = resolve_mapper_function(a_name)
            fb = resolve_mapper_function(b_name)
            functions.append(
                lambda x, fa=fa, fb=fb, w=weight: fa(x) * (1 - w) + fb(x) * w)
        else:
            functions.append(resolve_mapper_function(n))

    def chained(x):
        for f in functions:
            x = f(x)
        return x

    return chained


METRIC_DIV_MAPPER = ["none", "div_25", "div_10", "div_6", "div_4", "div_2", "div_1"]
RELATIVE_MUL_MAPPER = ["inv_mul_3", "inv_mul_2", "inv_mul_1", "none",
                       "mul_1", "mul_2", "mul_3"]
RELATIVE_SHIFT_MAPPER = ["shift_045", "shift_06", "shift_08", "none",
                         "shift_14", "shift_20", "shift_30"]
LEGACY_MAPPER = ["pow2", "softplus", "softplus2"]
MAPPER_ALL = ["auto"] + list(dict.fromkeys(
    LEGACY_MAPPER + RELATIVE_MUL_MAPPER + METRIC_DIV_MAPPER + RELATIVE_SHIFT_MAPPER))


def get_mapper_levels(metric_depth: bool, mapper_type=None):
    if mapper_type is None:
        return METRIC_DIV_MAPPER if metric_depth else RELATIVE_MUL_MAPPER
    if metric_depth:
        if mapper_type == "div":
            return METRIC_DIV_MAPPER
        raise ValueError(f"{mapper_type} is not metric depth mapper")
    if mapper_type == "mul":
        return RELATIVE_MUL_MAPPER
    if mapper_type == "shift":
        return RELATIVE_SHIFT_MAPPER
    raise ValueError(f"{mapper_type} is not relative depth mapper")


def resolve_mapper_name(mapper, foreground_scale, metric_depth, mapper_type=None):
    if mapper is not None:
        if mapper == "auto":
            return "none" if not metric_depth else "div_6"
        return mapper
    levels = get_mapper_levels(metric_depth=metric_depth, mapper_type=mapper_type)
    if float(foreground_scale).is_integer():
        return levels[int(foreground_scale) + 3]
    if foreground_scale > 0:
        a, b = math.floor(foreground_scale), math.ceil(foreground_scale)
        weight = foreground_scale - a
    else:
        fs = -foreground_scale
        a, b = -math.floor(fs), -math.ceil(fs)
        weight = fs - math.floor(fs)
    return f"{levels[a + 3]}+{levels[b + 3]}={round(weight, 2)}"
