"""HDR -> SDR tone mapping on the device (counterpart of
``nunif_tpu/video/hdr.py``).

BT.2020 PQ / HLG frames become BT.709 (or BT.601) SDR frames before the
model callback.  All math is fp32 tensor math on the frames' device (the
black end of the PQ curve is too sensitive for bf16); no kernel of its own:
the JAX package runs it as one fused XLA program, not in Pallas.

- ``mode="hable"`` (the default): PQ / HLG EOTF, a fixed exposure, the
  Hable filmic curve normalised by a white point, the BT.2020 -> BT.709 /
  601 matrix, the BT.709 piecewise OETF (``hdr2sdr_ref_float``).
- ``mode="bt2390"``: absolute nits, BT.2408's 203-nit reference white, a
  knee rolloff bounded by the content's peak (``choose_peak_nits``), the
  gamut matrix with a desaturating soft clip, display gamma 2.2
  (``hdr2sdr_float``).
"""
from __future__ import annotations

import torch

# AVColorTransferCharacteristic values (FFmpeg pixfmt.h)
TRC_PQ = 16
TRC_HLG = 18

SDR_WHITE_NITS = 203.0   # ITU-R BT.2408 reference white

# BT.2020 -> BT.709 primaries, D65 (rows sum to 1)
_BT2020_TO_BT709 = ((1.660491, -0.587641, -0.072850),
                    (-0.124550, 1.132900, -0.008349),
                    (-0.018151, -0.100579, 1.118730))
_Y2020 = (0.2627, 0.6780, 0.0593)
_Y709 = (0.2126, 0.7152, 0.0722)
_BT2020_TO_BT601 = ((1.5540, -0.5143, -0.0397),
                    (-0.1017, 1.1147, -0.0130),
                    (-0.0163, -0.0886, 1.1049))
# the 4-decimal BT.709 matrix of the Hable path
_BT2020_TO_BT709_REF = ((1.6605, -0.5876, -0.0728),
                        (-0.1246, 1.1329, -0.0083),
                        (-0.0182, -0.1006, 1.1187))

_PQ = dict(m1=2610.0 / 16384.0, m2=2523.0 / 4096.0 * 128.0, c1=3424.0 / 4096.0,
           c2=2413.0 / 4096.0 * 32.0, c3=2392.0 / 4096.0 * 32.0)
_HLG_ABC = (0.17883277, 0.28466892, 0.55991073)


def _const(values, x):
    return torch.tensor(values, dtype=torch.float32, device=x.device)


def _pq_linear(e):
    """SMPTE ST 2084 EOTF to [0, 1] linear (1.0 = 10000 nits)."""
    p = torch.pow(e, 1.0 / _PQ["m2"])
    return torch.pow(torch.clamp(p - _PQ["c1"], min=0.0)
                     / (_PQ["c2"] - _PQ["c3"] * p), 1.0 / _PQ["m1"])


def _hlg_inverse_oetf(e):
    a, b, c = _HLG_ABC
    return torch.where(e <= 0.5, (e * e) / 3.0, (torch.exp((e - c) / a) + b) / 12.0)


def pq_eotf(e):
    """SMPTE ST 2084 EOTF: non-linear [0, 1] -> absolute luminance in nits."""
    return 10000.0 * _pq_linear(torch.clamp(e, 0.0, 1.0))


def hlg_eotf(e, peak_nits=1000.0):
    """ARIB STD-B67 inverse OETF, scaled to a ``peak_nits`` display (nits,
    per channel)."""
    return peak_nits * _hlg_inverse_oetf(torch.clamp(e, 0.0, 1.0))


def _tonemap_luminance(y_rel, peak_rel, knee=0.75):
    """Identity below ``knee`` (1.0 = SDR white), then a monotone Hermite
    rolloff mapping [knee, peak_rel] onto [knee, 1]."""
    peak_rel = max(peak_rel, 1.0 + 1e-3)
    t = torch.clamp((y_rel - knee) / (peak_rel - knee), 0.0, 1.0)
    roll = knee + (1.0 - knee) * t * (2.0 - t)
    return torch.where(y_rel <= knee, y_rel, roll)


def _hable(v, e=0.02):
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, e, 0.30
    return ((v * (A * v + C * B) + D * E) / (v * (A * v + B) + D * F)) - E / F


def _mat(x, m):
    """x (..., 3) times the 3 x 3 matrix m's transpose."""
    return torch.einsum("...c,dc->...d", x, _const(m, x))


def hdr2sdr_ref_float(rgb, trc: int, output_colorspace: str = "bt709",
                      pq_exposure: float = 110.0, pq_white_point: float = 5.0,
                      hlg_exposure: float = 1.2, hlg_white_point: float = 0.8,
                      hlg_saturation_gain: float = 0.9):
    """The Hable tone map: float BT.2020 PQ / HLG RGB in [0, 1] ->
    BT.709 / 601 OETF RGB in [0, 1]."""
    x = rgb.float()
    if trc == TRC_PQ:
        lin = _pq_linear(x)
        exposure, white, hable_e = pq_exposure, pq_white_point, 0.02
    else:
        lin = _hlg_inverse_oetf(x)
        exposure, white, hable_e = hlg_exposure, hlg_white_point, 0.01
    sdr = _hable(lin * exposure, hable_e) / _hable(
        torch.tensor(white, dtype=torch.float32, device=x.device), hable_e)
    if trc == TRC_HLG and hlg_saturation_gain < 1.0:
        luma = torch.einsum("...c,c->...", sdr, _const(_Y709, sdr))[..., None]
        sdr = sdr * hlg_saturation_gain + luma * (1.0 - hlg_saturation_gain)
    matrix = (_BT2020_TO_BT709_REF if output_colorspace == "bt709"
              else _BT2020_TO_BT601)
    out = torch.clamp(_mat(sdr, matrix), 0.0, 1.0)
    out = torch.where(out < 0.018, out * 4.5, 1.099 * torch.pow(out, 0.45) - 0.099)
    return torch.clamp(out, 0.0, 1.0)


def hdr2sdr_float(rgb, trc: int, peak_nits: float):
    """The bt2390 tone map: float BT.2020 PQ / HLG RGB in [0, 1] -> BT.709
    gamma-2.2 RGB in [0, 1]."""
    rgb = rgb.float()
    if trc == TRC_HLG:
        nits = hlg_eotf(rgb)
        peak_nits = min(peak_nits, 1000.0) if peak_nits > 0 else 1000.0
    else:
        nits = pq_eotf(rgb)
    rel = nits / SDR_WHITE_NITS
    peak_rel = max(peak_nits, SDR_WHITE_NITS + 1.0) / SDR_WHITE_NITS
    y = torch.einsum("...c,c->...", rel, _const(_Y2020, rel))
    y_out = _tonemap_luminance(y, peak_rel)
    rel = rel * (y_out / torch.clamp(y, min=1e-6))[..., None]
    rgb709 = _mat(rel, _BT2020_TO_BT709)
    # soft-clip out-of-gamut negatives by desaturating toward luminance
    y709 = torch.clamp(torch.einsum("...c,c->...", rgb709, _const(_Y709, rgb709)),
                       0.0, 1.0)[..., None]
    neg = torch.clamp(rgb709.amin(dim=-1, keepdim=True), max=0.0)
    denom = torch.clamp(y709 - neg, min=1e-6)
    rgb709 = y709 + (rgb709 - y709) * (y709 / denom)
    return torch.pow(torch.clamp(rgb709, 0.0, 1.0), 1.0 / 2.2)


@torch.no_grad()
def hdr2sdr_frames(frames, trc: int = TRC_PQ, peak_nits: float = 1000.0,
                   out_uint16: bool = False, mode: str = "hable",
                   output_colorspace: str = "bt709"):
    """uint8 / uint16 (B, H, W, 3) HDR frames (a tensor, or numpy on the
    CPU) -> SDR frames, uint16 with ``out_uint16`` else uint8, on the
    frames' device."""
    frames = torch.as_tensor(frames)
    maxv = 65535.0 if frames.dtype == torch.uint16 else 255.0
    x = frames.float() / maxv
    if mode == "hable":
        y = hdr2sdr_ref_float(x, trc, output_colorspace=output_colorspace)
    else:
        y = hdr2sdr_float(x, trc, peak_nits)
    if out_uint16:
        return y.mul(65535.0).add(0.5).to(torch.uint16)
    return y.mul(255.0).add(0.5).to(torch.uint8)


def choose_peak_nits(reader) -> float:
    """The tone map's peak from the stream's HDR metadata: the mastering
    display's max luminance, else MaxCLL, else 1000 nits."""
    if getattr(reader, "master_max_luminance", 0) and \
            reader.master_max_luminance > SDR_WHITE_NITS:
        return float(reader.master_max_luminance)
    if getattr(reader, "max_cll", 0) and reader.max_cll > SDR_WHITE_NITS:
        return float(reader.max_cll)
    return 1000.0
