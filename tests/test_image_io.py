"""utils/image: built-in 8-bit PNG codec and Lanczos resize, checked against
Pillow (which the main path no longer needs)."""

import sys

import numpy as np
import pytest
from PIL import Image as PILImage

from colmap_pcd_tpu.utils import image as iu


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (20, 31, 4), (12, 9, 2)])
def test_png_roundtrip_against_pillow(shape, tmp_path, rng, monkeypatch):
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    ours = str(tmp_path / "ours.png")
    iu.write_png(ours, a)
    np.testing.assert_array_equal(np.asarray(PILImage.open(ours)), a)
    # Pillow's writer picks adaptive per-row filters (incl. Average/Paeth)
    theirs = str(tmp_path / "theirs.png")
    PILImage.fromarray(a).save(theirs)
    np.testing.assert_array_equal(iu._read_png(theirs), a)
    refs = {m: np.asarray(PILImage.open(theirs).convert(m)) for m in ("L", "RGB")}
    monkeypatch.setitem(sys.modules, "PIL", None)  # the built-in reader
    for mode, ref in refs.items():
        np.testing.assert_array_equal(iu._read(theirs, mode), ref)
    assert iu.image_size(theirs) == (shape[1], shape[0])


def test_read_decodes_with_pillow_when_it_imports(tmp_path, rng, monkeypatch):
    """The built-in reader is only the fallback: its Paeth loop is slow."""
    a = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    p = str(tmp_path / "a.png")
    PILImage.fromarray(a).save(p)

    def unused(path):
        raise AssertionError("built-in reader used although Pillow imports")

    monkeypatch.setattr(iu, "_read_png", unused)
    np.testing.assert_array_equal(iu.imread_rgb(p), a)
    np.testing.assert_array_equal(
        iu.imread_gray_u8(p), np.asarray(PILImage.open(p).convert("L")))


def test_png_palette_and_smooth_image(tmp_path, rng):
    rgb = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    p = str(tmp_path / "pal.png")
    PILImage.fromarray(rgb).convert("P").save(p)
    np.testing.assert_array_equal(
        iu.imread_rgb(p), np.asarray(PILImage.open(p).convert("RGB")))
    yy, xx = np.mgrid[0:64, 0:96]
    smooth = (127 + 60 * np.sin(xx / 7.0) + 60 * np.cos(yy / 11.0)).astype(np.uint8)
    s = str(tmp_path / "smooth.png")
    PILImage.fromarray(smooth).save(s)
    np.testing.assert_array_equal(iu.imread_gray_u8(s), smooth)
    np.testing.assert_allclose(iu.imread_gray(s), smooth / 255.0, atol=1e-7)


@pytest.mark.parametrize("max_size", [160, 250, 97])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_max_matches_pillow_lanczos(max_size, channels, rng):
    """Same taps and 8-bit passes as Pillow's LANCZOS; Pillow rounds in fixed
    point, so single pixels may differ by one grey level."""
    yy, xx = np.mgrid[0:240, 0:320]
    base = 127 + 50 * np.sin(xx / 5.0) + 50 * np.cos(yy / 7.0)
    img = np.clip(base[..., None] + rng.normal(0, 20, (240, 320, channels)), 0, 255)
    img = img.astype(np.uint8)[..., 0] if channels == 1 else img.astype(np.uint8)
    out, scale = iu.resize_max(img, max_size)
    assert max(out.shape[:2]) <= max_size and scale == max_size / 320
    ref = np.asarray(PILImage.fromarray(img).resize(
        (out.shape[1], out.shape[0]), PILImage.LANCZOS))
    d = np.abs(out.astype(int) - ref)
    assert d.max() <= 1 and d.mean() < 0.01, (d.max(), d.mean())
    f, _ = iu.resize_max(img.astype(np.float32) / 255.0, max_size)
    np.testing.assert_allclose(f, out / 255.0, atol=1e-6)


def test_other_formats_name_pillow_when_missing(tmp_path, monkeypatch):
    p = str(tmp_path / "a.jpg")
    PILImage.fromarray(np.zeros((8, 8), np.uint8)).save(p)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs Pillow"):
        iu.imread_gray(p)
    # PNG keeps working without Pillow
    q = str(tmp_path / "a.png")
    iu.imwrite(q, np.full((4, 5), 7, np.uint8))
    assert iu.imread_gray_u8(q).sum() == 7 * 20
