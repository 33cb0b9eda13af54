"""8-way test-time augmentation on NHWC tensors (counterpart of
``nunif_tpu/transforms/tta.py``): H is dim -3, W dim -2.

``tta_split`` returns the 8 transforms of the dihedral group, ``tta_merge``
inverts each, averages and clips to [0, 1].
"""
import torch


def _hflip(x):
    return torch.flip(x, dims=(-2,))


def _vflip(x):
    return torch.flip(x, dims=(-3,))


def _tr(x):
    return torch.rot90(x, 1, dims=(-3, -2))


def _itr(x):
    return torch.rot90(x, -1, dims=(-3, -2))


def tta_split(x: torch.Tensor):
    xv = _vflip(x)
    xt = _tr(x)
    xtv = _vflip(xt)
    return (x, _hflip(x), xv, _hflip(xv),
            xt, _hflip(xt), xtv, _hflip(xtv))


def tta_merge(xs) -> torch.Tensor:
    (x, x_h, x_v, x_vh, x_t, x_th, x_tv, x_tvh) = xs
    avg = (x + _hflip(x_h) + _vflip(x_v) + _vflip(_hflip(x_vh))
           + _itr(x_t) + _itr(_hflip(x_th)) + _itr(_vflip(x_tv))
           + _itr(_vflip(_hflip(x_tvh)))) / 8.0
    return avg.clamp(0.0, 1.0)


def tta_render(renderer, x: torch.Tensor, tile_size=None, batch_size=None):
    """8-way TTA through a ``TiledRenderer``."""
    outs = [renderer.render(xx, tile_size=tile_size, batch_size=batch_size)
            for xx in tta_split(x)]
    return tta_merge(outs)
