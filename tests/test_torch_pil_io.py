"""The port's image I/O and ICC profiles (``nunif_tpu_torch/utils/pil_io.py``).

``load_image`` converts an image with an embedded profile to sRGB.  The
port's ``save_image`` then embeds no profile, so the saved file displays
as the source did; where the profile fails to convert, the pixels are
still in it and it is kept.  The reference (``nunif_tpu/utils/pil_io.py``)
embeds the source's profile again after the conversion, so a
colour-managed viewer applies it twice: the port diverges on purpose, and
the last test here records the reference's behaviour.

The non-sRGB profile is built inside the test: lcms's sRGB with its
parametric tone curve replaced by a linear one (gamma 1).
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import io
import struct

import numpy as np
import pytest

from PIL import Image, ImageCms

from nunif_tpu.utils import pil_io as jpil_io
from nunif_tpu_torch.utils import pil_io

GRAY = 64


def _linear_srgb_profile() -> bytes:
    """lcms's sRGB profile with every TRC tag a 'para' curve of type 0,
    gamma 1.0: sRGB primaries, linear light."""
    icc = bytearray(ImageCms.ImageCmsProfile(
        ImageCms.createProfile("sRGB")).tobytes())
    (count,) = struct.unpack(">I", icc[128:132])
    patched = 0
    for i in range(count):
        sig, off, size = struct.unpack(">4sII", icc[132 + 12 * i:144 + 12 * i])
        if sig in (b"rTRC", b"gTRC", b"bTRC"):
            curve = b"para" + bytes(4) + struct.pack(">HH", 0, 0) + \
                struct.pack(">i", 1 << 16)
            icc[off:off + size] = curve + bytes(size - len(curve))
            patched += 1
    assert patched == 3
    return bytes(icc)


def _displayed(path) -> np.ndarray:
    """The file's pixels as a colour-managed viewer shows them: converted
    from the embedded profile to sRGB, or as they are without one."""
    with Image.open(path) as im:
        im.load()
        icc = im.info.get("icc_profile")
        rgb = im.convert("RGB")
        if icc:
            rgb = ImageCms.profileToProfile(
                rgb, ImageCms.ImageCmsProfile(io.BytesIO(icc)),
                ImageCms.createProfile("sRGB"), outputMode="RGB")
        return np.asarray(rgb, dtype=np.float32)


def _gray_png(path, icc):
    Image.fromarray(np.full((8, 8, 3), GRAY, np.uint8)).save(path, icc_profile=icc)


def test_converted_image_displays_as_its_source(tmp_path):
    src, out = tmp_path / "in.png", tmp_path / "out.png"
    _gray_png(src, _linear_srgb_profile())
    shown = _displayed(src)
    assert abs(float(shown.mean()) - 137) <= 1  # linear 64 shows as sRGB ~137
    x, meta = pil_io.load_image(str(src))
    pil_io.save_image(x, str(out), meta)
    np.testing.assert_allclose(_displayed(out), shown, rtol=0, atol=1.0)
    assert meta.srgb and meta.icc_profile
    with Image.open(out) as im:
        assert not im.info.get("icc_profile")  # the pixels are sRGB now


@pytest.mark.parametrize("ext", [".png", ".webp"])
def test_profile_that_fails_to_convert_is_kept(tmp_path, ext):
    """Bytes lcms cannot read: the pixels stay as stored, and so does the
    profile they are in."""
    bad = b"not an ICC profile" * 8
    src, out = tmp_path / "in.png", tmp_path / f"out{ext}"
    _gray_png(src, bad)
    x, meta = pil_io.load_image(str(src))
    assert not meta.srgb and meta.icc_profile == bad
    np.testing.assert_array_equal(np.round(x * 255), np.full((8, 8, 3), GRAY))
    pil_io.save_image(x, str(out), meta)
    with Image.open(out) as im:
        assert im.info.get("icc_profile") == bad


def test_image_without_profile_saves_without_one(tmp_path):
    src, out = tmp_path / "in.png", tmp_path / "out.png"
    Image.fromarray(np.full((4, 4, 3), GRAY, np.uint8)).save(src)
    x, meta = pil_io.load_image(str(src))
    assert not meta.srgb and not meta.icc_profile
    pil_io.save_image(x, str(out), meta)
    with Image.open(out) as im:
        assert not im.info.get("icc_profile")
    np.testing.assert_array_equal(_displayed(out), _displayed(src))


def test_reference_applies_the_profile_twice(tmp_path):
    """The divergence the port makes on purpose: the reference's round trip
    of the same file displays far brighter than its source."""
    src, out = tmp_path / "in.png", tmp_path / "out.png"
    _gray_png(src, _linear_srgb_profile())
    x, meta = jpil_io.load_image(str(src))
    jpil_io.save_image(x, str(out), meta)
    assert float(_displayed(out).mean()) - float(_displayed(src).mean()) > 40
