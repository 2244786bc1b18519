"""The port's numpy JPEG decoder (``utils/jpeg.py``) against the JAX
package's native loader (libjpeg behind ``native.decode_image``) and PIL,
on the CPU: ``load_rgb`` on baseline JPEGs (4:4:4, 4:2:2, 4:2:0, grey,
restart intervals) and progressive ones, written by PIL at sizes that are
not multiples of the MCU, equals the JAX package's ``load_rgb`` sample for
sample at the native size and within 1e-6 after the resize; ``load_mask``
on a JPEG equals the JAX package's (PIL's decode, "L" luma, bicubic
resize)."""

import numpy as np
import pytest
from PIL import Image

from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu import native
from fateavatar_tpu.train import datasets as jdatasets

from fateavatar_tpu_torch.train import datasets as tdatasets
from fateavatar_tpu_torch.utils import jpeg

H, W = 37, 45      # 3 x 3 MCUs at 4:2:0, cut

# kind -> PIL save options (grey kinds save the first channel)
JPEG_KINDS = {
    "444": dict(subsampling=0, quality=90),
    "422": dict(subsampling=1, quality=90),
    "420": dict(subsampling=2, quality=90),
    "grey": dict(quality=85),
    "progressive": dict(progressive=True, subsampling=2, quality=90),
    "progressive_444": dict(progressive=True, subsampling=0, quality=95),
    "progressive_grey": dict(progressive=True, quality=85),
    "restarts": dict(subsampling=2, quality=90, restart_marker_blocks=3),
    "restart_rows": dict(subsampling=1, quality=75, restart_marker_rows=1),
    "progressive_restarts": dict(progressive=True, quality=90, restart_marker_blocks=2),
    "quality100": dict(subsampling=0, quality=100),
}


def _image(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    img[4:14] //= 3             # smooth rows next to noisy ones
    yy, xx = np.mgrid[:h, :w]
    img[20:] = np.stack([xx * 5, yy * 6, (xx + yy) * 3], -1)[20:].astype(np.uint8)
    return img


def _write(path, kind, seed):
    img = _image(seed)
    if "grey" in kind:
        Image.fromarray(img[..., 0]).save(path, **JPEG_KINDS[kind])
    else:
        Image.fromarray(img).save(path, **JPEG_KINDS[kind])


@pytest.mark.parametrize("kind", sorted(JPEG_KINDS))
def test_load_rgb_matches_jax(kind, tmp_path):
    """The raw decode equals PIL's (libjpeg behind both), and load_rgb
    equals the JAX package's: exact at the native size, within 1e-6 after
    the bilinear resize, on both backgrounds, alpha 1."""
    assert native.available(), "the JAX package's native loader must build here"
    path = str(tmp_path / f"{kind}.jpg")
    _write(path, kind, sorted(JPEG_KINDS).index(kind))
    np.testing.assert_array_equal(jpeg.read_jpeg(path),
                                  np.asarray(Image.open(path).convert("RGB")))
    for res, atol in (((W, H), 0.0), ((16, 40), 1e-6), ((64, 50), 1e-6)):
        for bg in ("black", "white"):
            j_rgb, j_a = jdatasets.load_rgb(path, res, bg, return_alpha=True)
            t_rgb, t_a = tdatasets.load_rgb(path, res, bg, return_alpha=True)
            assert t_rgb.shape == (res[1], res[0], 3) and t_rgb.dtype == np.float32
            np.testing.assert_allclose(t_rgb, j_rgb, rtol=0, atol=atol)
            np.testing.assert_array_equal(t_a, j_a)


@pytest.mark.parametrize("kind", ["420", "grey", "progressive"])
def test_load_mask_matches_jax(kind, tmp_path):
    """load_mask on a JPEG equals the JAX package's (PIL) bit for bit, at
    the native size and resized."""
    path = str(tmp_path / f"mask_{kind}.jpg")
    _write(path, kind, 7)
    for res in ((W, H), (32, 24), (90, 70)):
        np.testing.assert_array_equal(tdatasets.load_mask(path, res),
                                      jdatasets.load_mask(path, res))


def test_sizes_and_exif(tmp_path):
    """Odd sizes down to 1x1 (one partial block, fancy upsampling off at 2
    samples wide or less) and a JPEG with an EXIF segment decode as libjpeg
    decodes them."""
    for i, (h, w) in enumerate(((1, 1), (3, 2), (9, 17), (16, 16), (33, 8))):
        path = str(tmp_path / f"s{i}.jpg")
        Image.fromarray(_image(i, h, w)).save(path, subsampling=2, quality=90)
        rgba, c = native.decode_image(path, w, h)
        assert c == 3
        np.testing.assert_array_equal(
            jpeg.read_jpeg(path), np.round(rgba[..., :3] * 255).astype(np.uint8))
    path = str(tmp_path / "exif.jpg")
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(_image(9)).save(path, exif=exif, quality=90)
    np.testing.assert_array_equal(jpeg.read_jpeg(path),
                                  np.asarray(Image.open(path).convert("RGB")))
