"""The port's data path against the JAX package, on the CPU: the PNG codec
(Adam7-interlaced PNGs included) and ``load_rgb`` against the JAX package's
native loader (JPEGs: tests/test_torch_jpeg.py), the IMAvatar and
INSTA readers on generated layouts, the image writers and the video GIF
fallback (with PIL hidden), ``construct_dataset``'s type inference, the host
utilities, and ``render()``'s ``t_cutoff`` on both routes."""

import os
import shutil
import struct
import sys
import zlib

import jax  # noqa: F401  (JAX on the CPU, set up by conftest)
import numpy as np
import pytest
import torch
from PIL import Image

from torch_layouts import orbit, write_imavatar, write_insta
from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu import native
from fateavatar_tpu.train import datasets as jdatasets
from fateavatar_tpu.utils import logging as jlogging
from fateavatar_tpu.utils import misc as jmisc

from fateavatar_tpu_torch.cli import common
from fateavatar_tpu_torch.ops.camera import make_camera
from fateavatar_tpu_torch.render.render import RenderConfig, render
from fateavatar_tpu_torch.render.splats import make_gaussians
from fateavatar_tpu_torch.train import datasets as tdatasets
from fateavatar_tpu_torch.utils import logging as tlogging
from fateavatar_tpu_torch.utils import misc as tmisc
from fateavatar_tpu_torch.utils import png
from fateavatar_tpu_torch.utils.config import load_config

RES = 24


def _pil_save(path, arr):
    Image.fromarray(arr).save(path)


def _avg_filtered_png(path, arr):
    """An 8-bit RGB PNG whose rows cycle through all five filter types
    (PIL's encoder never picks Avg)."""
    h, w, c = arr.shape
    prev = np.zeros(w * c, np.int64)
    out = b""
    for y in range(h):
        kind = y % 5
        cur = arr[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if kind == 0:
            f = cur
        elif kind == 1:
            f = cur - left
        elif kind == 2:
            f = cur - prev
        elif kind == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            f = cur - pred
        out += bytes([kind]) + (f % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(out)) + chunk(b"IEND", b""))


def _pack_rows(samples, depth):
    """[h, w, c] integer samples as PNG scanline bytes [h, stride]."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, w * c).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    bits = ((samples[..., 0][..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(h, w * depth), axis=1)


def _filter_rows(rows, bpp):
    """Each row filtered with type (row % 5): all five filters."""
    out, prev = b"", np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        kind = y % 5
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            f = row
        elif kind == 1:
            f = row - left
        elif kind == 2:
            f = row - prev
        elif kind == 3:
            f = row - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            f = row - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out += bytes([kind]) + (f % 256).astype(np.uint8).tobytes()
        prev = row
    return out


def _adam7_png(path, samples, color, depth, plte=None, trns=None):
    """An Adam7-interlaced PNG of the samples [h, w, c] (PIL writes none):
    each non-empty pass filtered on its own rows, through all five filter
    types."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    data = b""
    for x0, y0, dx, dy in png.ADAM7:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            data += _filter_rows(_pack_rows(sub, depth), bpp)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    out = png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 1))
    if plte is not None:
        out += chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    with open(path, "wb") as fh:
        fh.write(out + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))


def _write_adam7(path, kind, rng):
    h, w = (RES, RES + 5) if kind != "adam7_tiny" else (3, 2)
    if kind in ("adam7_rgb", "adam7_tiny"):
        _adam7_png(path, rng.integers(0, 256, (h, w, 3)), 2, 8)
    elif kind == "adam7_rgba16":
        _adam7_png(path, rng.integers(0, 65536, (h, w, 4)), 6, 16)
    elif kind == "adam7_grey2":
        _adam7_png(path, rng.integers(0, 4, (h, w, 1)), 0, 2)
    elif kind == "adam7_palette_trns":
        _adam7_png(path, rng.integers(0, 12, (h, w, 1)), 3, 4,
                   plte=rng.integers(0, 256, (12, 3)), trns=bytes(range(0, 240, 40)))


def _write_kind(path, kind, rng):
    """One PNG of each kind the readers meet, written by PIL (adaptive
    filters: Sub, Up and Paeth rows) or, for 'filters', by hand."""
    rgb = (rng.random((RES, RES + 5, 3)) * 255).astype(np.uint8)
    rgb[4:12] //= 3        # smooth rows: the adaptive filter picks Up / Paeth
    if kind == "rgb":
        _pil_save(path, rgb)
    elif kind == "rgba":
        _pil_save(path, (rng.random((RES, RES + 5, 4)) * 255).astype(np.uint8))
    elif kind == "grey":
        _pil_save(path, rgb[..., 0])
    elif kind == "grey16":
        Image.fromarray((rng.random((RES, RES + 5)) * 65535).astype(np.uint16)).save(path)
    elif kind == "grey_alpha":
        Image.fromarray(rgb[..., :2], "LA").save(path)
    elif kind == "grey1":
        Image.fromarray(rng.random((RES, RES + 5)) > 0.5).save(path)
    elif kind == "palette":
        Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=40).save(path)
    elif kind == "palette4":      # 12 colours: PIL writes 4-bit indices
        Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=12).save(path)
    elif kind == "palette_trns":
        Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=40).save(
            path, transparency=3)
    elif kind == "filters":
        _avg_filtered_png(path, rgb)
    elif kind.startswith("adam7"):
        _write_adam7(path, kind, rng)


PNG_KINDS = ("rgb", "rgba", "grey", "grey16", "grey_alpha", "grey1", "palette",
             "palette4", "palette_trns", "filters", "adam7_rgb", "adam7_rgba16",
             "adam7_grey2", "adam7_palette_trns", "adam7_tiny")


@pytest.mark.parametrize("kind", PNG_KINDS)
def test_load_rgb_matches_jax(kind, tmp_path):
    """load_rgb against the JAX package's (its native libpng loader): exact
    at the native size, within 1e-6 after the bilinear resize, on both
    backgrounds, with the alpha channel; the raw decode equals PIL's."""
    assert native.available(), "the JAX package's native loader must build here"
    path = str(tmp_path / f"{kind}.png")
    _write_kind(path, kind, np.random.default_rng(PNG_KINDS.index(kind)))
    if kind == "grey16":     # libpng's strip_16 keeps the high byte
        ref = np.repeat((np.asarray(Image.open(path)) >> 8)[..., None], 3, -1)
    elif kind == "adam7_rgba16":
        ref = None           # PIL reads 16-bit RGBA as 8-bit its own way
    else:
        ref = np.asarray(Image.open(path).convert(
            "RGBA" if png.read_png(path).shape[2] == 4 else "RGB"))
    if ref is not None:
        np.testing.assert_array_equal(png.read_png(path), ref)
    w, h = Image.open(path).size
    for res, atol in (((w, h), 0.0), ((16, 40), 1e-6)):
        for bg in ("black", "white"):
            j_rgb, j_a = jdatasets.load_rgb(path, res, bg, return_alpha=True)
            t_rgb, t_a = tdatasets.load_rgb(path, res, bg, return_alpha=True)
            assert t_rgb.shape == (res[1], res[0], 3) and t_rgb.dtype == np.float32
            np.testing.assert_allclose(t_rgb, j_rgb, rtol=0, atol=atol)
            np.testing.assert_allclose(t_a, j_a, rtol=0, atol=atol)


def test_codec_refuses_other_formats(tmp_path):
    """What the JAX package's libjpeg / libpng loader does not decode either
    raises ValueError naming the file: arithmetic-coded, 12-bit and CMYK
    JPEGs, a PNG with an unknown interlace method, a file that is neither
    PNG nor JPEG."""
    base = tmp_path / "frame.jpg"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(base)
    data = base.read_bytes()
    sof = data.index(b"\xff\xc0")
    for name, patched, match in (
            ("arith.jpg", data[:sof + 1] + b"\xc9" + data[sof + 2:], "arithmetic"),
            ("deep.jpg", data[:sof + 4] + b"\x0c" + data[sof + 5:], "12-bit")):
        (tmp_path / name).write_bytes(patched)
        with pytest.raises(ValueError, match=f"{name}.*{match}"):
            tdatasets.load_rgb(str(tmp_path / name), (8, 8))
    Image.new("CMYK", (8, 8), (10, 20, 30, 40)).save(tmp_path / "cmyk.jpg")
    with pytest.raises(ValueError, match="cmyk.jpg.*CMYK"):
        tdatasets.load_rgb(str(tmp_path / "cmyk.jpg"), (8, 8))
    bad = tmp_path / "laced.png"
    hdr = struct.pack(">IIBBBBB", 8, 8, 8, 2, 0, 0, 2)
    bad.write_bytes(png.SIGNATURE + struct.pack(">I", 13) + b"IHDR" + hdr
                    + struct.pack(">I", zlib.crc32(b"IHDR" + hdr) & 0xFFFFFFFF))
    with pytest.raises(ValueError, match="laced.png"):
        png.read_png(str(bad))
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "frame.bmp")
    with pytest.raises(ValueError, match="frame.bmp"):
        tdatasets.load_rgb(str(tmp_path / "frame.bmp"), (8, 8))


def test_image_writers_match_jax(tmp_path):
    """save_image and save_image_grid read back by PIL equal the JAX
    package's files; write_png round-trips grey, RGB and RGBA."""
    rng = np.random.default_rng(3)
    imgs = [rng.random((RES, RES, 3)).astype(np.float32) * 1.2 - 0.1 for _ in range(5)]
    for name, jfn, tfn, arg in (("one", jlogging.save_image, tlogging.save_image, imgs[0]),
                                ("grid", lambda p, x: jlogging.save_image_grid(p, x, cols=3),
                                 lambda p, x: tlogging.save_image_grid(p, x, cols=3), imgs)):
        jfn(str(tmp_path / f"j_{name}.png"), arg)
        tfn(str(tmp_path / f"t_{name}.png"), arg)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"t_{name}.png")),
                                      np.asarray(Image.open(tmp_path / f"j_{name}.png")))
    for c in (1, 3, 4):
        arr = (rng.random((RES, 7, c)) * 255).astype(np.uint8)
        png.write_png(str(tmp_path / f"c{c}.png"), arr)
        back = np.asarray(Image.open(tmp_path / f"c{c}.png"))
        np.testing.assert_array_equal(back.reshape(arr.shape), arr)


def test_writers_and_gif_fallback_without_pil(tmp_path, monkeypatch):
    """With PIL hidden (sys.modules) and no ffmpeg, save_image works and
    write_video writes a GIF; read back by PIL: every frame, the size, and
    each frame exactly its median-cut palette's colours (``quantize_frame``:
    the LZW decodes to the indices written). On this uniform noise, against
    the JAX package's GIF of the same frames (PIL's median cut): each
    frame's mean absolute error at most 1.1x the JAX GIF's plus 0.5 levels,
    and no pixel's channel further from the source than the JAX GIF's
    largest error on that frame (PIL's 52-55 levels, the port's 32-38)."""
    rng = np.random.default_rng(4)
    frames = [(rng.random((RES, 2 * RES, 3)) * 255).astype(np.uint8) for _ in range(3)]
    with monkeypatch.context() as m:
        for mod in [k for k in sys.modules if k == "PIL" or k.startswith("PIL.")]:
            m.setitem(sys.modules, mod, None)
        m.setattr(tlogging.shutil, "which", lambda name: None)
        with pytest.raises(ImportError):
            import PIL.Image  # noqa: F401
        assert tlogging.write_video(str(tmp_path / "v.mp4"), frames, fps=25)
        tlogging.save_image(str(tmp_path / "f.png"), frames[0])
    assert not (tmp_path / "v.mp4").exists()
    monkeypatch.setattr(shutil, "which", lambda name: None)     # the JAX writer's lookup
    assert jlogging.write_video(str(tmp_path / "j.mp4"), frames, fps=25)
    gif, jgif = Image.open(tmp_path / "v.gif"), Image.open(tmp_path / "j.gif")
    assert gif.n_frames == 3 and gif.size == (2 * RES, RES)
    for i, fr in enumerate(frames):
        gif.seek(i)
        jgif.seek(i)
        got = np.asarray(gif.convert("RGB"))
        idx, pal = tlogging.quantize_frame(fr)
        np.testing.assert_array_equal(got, pal[idx], err_msg=str(i))
        err = np.abs(got.astype(int) - fr)
        jerr = np.abs(np.asarray(jgif.convert("RGB")).astype(int) - fr)
        assert err.mean() <= 1.1 * jerr.mean() + 0.5, (i, err.mean(), jerr.mean())
        assert err.max() <= jerr.max(), (i, err.max(), jerr.max())
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "f.png")), frames[0])


def _imavatar_layout(root, rng, mode, n):
    imgs = [(rng.random((RES, RES, 4)) * 255).astype(np.uint8) for _ in range(n)]
    write_imavatar(root, mode, imgs, orbit(n), rng.normal(size=(n, 50)),
                   rng.normal(size=(n, 15)) * 0.1, rng.normal(size=100), 0.8, _pil_save)


def _assert_readers_equal(j, t, res):
    for k in ("world_mats", "expressions", "flame_pose", "shape_params", "intrinsics",
              "mean_expression", "var_expression"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k), err_msg=k)
    assert (t.fovx, t.fovy, t.n_shape, t.n_exp, t.type_name, t.optimize_tracking) == (
        j.fovx, j.fovy, j.n_shape, j.n_exp, j.type_name, j.optimize_tracking)
    assert [r.__dict__ for r in t.records] == [r.__dict__ for r in j.records]
    for i in range(len(j)):
        a, b = j.sample(i), t.sample(i)
        assert sorted(a) == sorted(b)
        for k in ("idx", "img_name", "fovx", "fovy"):
            assert a[k] == b[k], k
        for k in ("expression", "flame_pose", "cam_pose"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        for k in ("rgb", "object_mask"):
            np.testing.assert_array_equal(b["ground_truth"][k], a["ground_truth"][k], err_msg=k)
    # camera(): the JAX package's make_camera of (R = w2v[:3, :3]^T, T); the
    # port's make_camera is held to JAX's in test_torch_ops.py
    ct = t.camera(0, *res, device="cpu")
    want = make_camera(j.world_mats[0][:3, :3].T, j.world_mats[0][:3, 3], j.fovx, j.fovy,
                       *res, device="cpu")
    for k in ("view", "proj", "full_proj", "campos"):
        assert torch.equal(getattr(ct, k), getattr(want, k)), k


def test_imavatar_reader_matches_jax(tmp_path):
    """A generated IMAvatar layout (RGBA frames, fx < 0) read by both
    packages: world_mats, intrinsics, fov, expressions, poses and the
    sample() dicts exact; the reader returns the world->view matrices the
    layout was written from."""
    rng = np.random.default_rng(5)
    root = str(tmp_path / "imavatar" / "subj")
    _imavatar_layout(root, rng, "train", 3)
    kw = dict(use_mean_expression=True, use_var_expression=True, background_color="white")
    j = jdatasets.IMAvatarDataset(root, "train", (RES, RES), **kw)
    t = tdatasets.IMAvatarDataset(root, "train", (RES, RES), **kw)
    _assert_readers_equal(j, t, (RES, RES))
    np.testing.assert_allclose(t.world_mats, orbit(3), atol=1e-6)
    assert abs(t.fovx - 0.8) < 1e-6 and abs(t.fovy - 0.8) < 1e-6


def test_insta_reader_matches_jax(tmp_path):
    """A generated INSTA layout (unsorted frames, off-centre intrinsics,
    6d jaw and eye rotations) read by both packages, exact."""
    rng = np.random.default_rng(6)
    root = str(tmp_path / "insta" / "subj")
    c2w = np.linalg.inv(orbit(3, distance=1.0))
    imgs = [(rng.random((RES, RES, 3)) * 255).astype(np.uint8) for _ in range(3)]
    write_insta(root, "train", imgs, c2w, rng, _pil_save)
    j = jdatasets.InstaDataset(root, "train", (RES, RES), subsample=1)
    t = tdatasets.InstaDataset(root, "train", (RES, RES), subsample=1)
    _assert_readers_equal(j, t, (RES, RES))
    assert np.abs(t.flame_pose[:, 6:]).max() > 0


def test_construct_dataset_and_datasets(tmp_path):
    """Type inference from the path, the config's subsample and cache
    (cli/common.construct_datasets), the FlashAvatar inputs (each frame's
    mouth mask, matted/ -> parsing/, _mouth.png) as the JAX package reads
    them, and load_mask on a layout's frame against the JAX package's."""
    rng = np.random.default_rng(7)
    root = str(tmp_path / "IMAvatar" / "subj")
    _imavatar_layout(root, rng, "train", 4)
    _imavatar_layout(root, rng, "test", 3)
    assert isinstance(tdatasets.construct_dataset(root, "train", (RES, RES)),
                      tdatasets.IMAvatarDataset)
    with pytest.raises(ValueError, match="cannot infer"):
        tdatasets.construct_dataset(str(tmp_path / "subj"), "train", (RES, RES))
    ins = str(tmp_path / "my_insta_set")
    write_insta(ins, "test", [np.zeros((RES, RES, 3), np.uint8)], np.eye(4)[None], rng,
                _pil_save)
    assert isinstance(tdatasets.construct_dataset(ins, "test", (RES, RES)),
                      tdatasets.InstaDataset)
    cfg = load_config(None, [f"dataset.root_path={root}", f"dataset.img_res=[{RES},{RES}]",
                             "dataset.train_subsample=2", "dataset.cache_images=false"])
    train, test = common.construct_datasets(cfg)
    assert (len(train), len(test), train.cache_images) == (2, 3, False)
    assert [r.img_name for r in train.records] == ["0", "2"]
    train.sample(1)
    assert train._cache == {}
    for i, r in enumerate(train.records):
        mouth = os.path.dirname(r.image_path).replace("matted", "parsing")
        os.makedirs(mouth, exist_ok=True)
        _pil_save(os.path.join(mouth, f"{r.img_name}_mouth.png"),
                  (rng.random((RES + 4, RES, 3)) * 255).astype(np.uint8))
    jf = jdatasets.IMAvatarDataset(root, "train", (RES, RES), is_flashavatar=True,
                                   subsample=2)
    tf = tdatasets.IMAvatarDataset(root, "train", (RES, RES), is_flashavatar=True,
                                   subsample=2)
    for i in range(len(tf)):
        got = tf.sample(i)["ground_truth"]["mouth_mask"]
        assert got.shape == (RES, RES, 1)
        np.testing.assert_array_equal(got, jf.sample(i)["ground_truth"]["mouth_mask"])
    # load_mask is ported (the completion slice): PIL's grey and bicubic,
    # bit-equal with the JAX package's reader
    path = train.records[0].image_path
    for res in ((RES, RES), (RES // 2, RES + 3)):
        np.testing.assert_array_equal(tdatasets.load_mask(path, res),
                                      jdatasets.load_mask(path, res))


def test_misc_matches_jax(tmp_path):
    """Host utilities: heat map and background colours as JAX's; seeding
    seeds torch too; file_backup copies the port and configs, not the
    kernels' build directory."""
    w = np.linspace(-0.2, 1.2, 50).reshape(5, 10)
    np.testing.assert_array_equal(tmisc.colorize_weights_map(w), jmisc.colorize_weights_map(w))
    for name in ("white", "black"):
        np.testing.assert_array_equal(tmisc.get_bg_color(name, device="cpu").numpy(),
                                      np.asarray(jmisc.get_bg_color(name)))
    tmisc.seed_everything(3)
    a = torch.rand(3)
    tmisc.seed_everything(3)
    assert torch.equal(a, torch.rand(3))
    src = tmp_path / "repo"
    for rel in ("fateavatar_tpu_torch/train/x.py", "fateavatar_tpu_torch/_build/y.py",
                "configs/c.yaml", "fateavatar_tpu_torch/csrc/k.cu"):
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        (src / rel).write_text("x")
    tmisc.file_backup(str(tmp_path / "ws"), repo_root=str(src))
    got = sorted(os.path.relpath(os.path.join(r, f), tmp_path / "ws" / "archive")
                 for r, _, fs in os.walk(tmp_path / "ws" / "archive") for f in fs)
    assert got == ["configs/c.yaml", "fateavatar_tpu_torch/train/x.py"]


def _dense_scene(n=300, seed=8):
    """Splats dense enough in front of the camera that pixels terminate."""
    rng = np.random.default_rng(seed)
    g = make_gaussians(
        np.concatenate([rng.normal(size=(n, 2)) * 0.15, rng.random((n, 1)) * 0.2], 1),
        np.log(np.full((n, 3), 0.08)), np.tile([1.0, 0, 0, 0], (n, 1)),
        np.full((n, 1), 4.0), rng.random((n, 1, 3)) - 0.5, device="cpu")
    cam = make_camera(np.eye(3), [0.0, 0.0, 1.0], 0.8, 0.8, 32, 32, device="cpu")
    return cam, g, torch.ones(3)


def test_t_cutoff_on_both_routes():
    """'tiles' ignores t_cutoff (as the JAX package does); 'instances'
    takes 0 < t_cutoff <= 1e-4 with the exact blend's bits, and above that
    runs the early exit, which changes the frame where it cuts a tile
    (tests/test_torch_render_options.py holds it against JAX)."""
    cam, g, bg = _dense_scene()
    base = render(cam, g, bg, config=RenderConfig())
    assert float(base["t_final"].min()) < 1.1e-4          # some pixels terminate
    for cfg in (RenderConfig(t_cutoff=1e-4), RenderConfig(t_cutoff=5e-5)):
        out = render(cam, g, bg, config=cfg)
        assert torch.equal(out["render"], base["render"])
        assert torch.equal(out["t_final"], base["t_final"])
    tiles = RenderConfig(kernel="tiles", max_per_tile=512, chunk=32)
    ref = render(cam, g, bg, config=tiles)["render"]
    for cut in (1e-4, 0.5):
        got = render(cam, g, bg, config=RenderConfig(kernel="tiles", max_per_tile=512,
                                                       chunk=32, t_cutoff=cut))["render"]
        assert torch.equal(got, ref)
    # 0.99: every tile has pixels at its edge that few splats reach
    cut = render(cam, g, bg, config=RenderConfig(t_cutoff=0.99))
    assert torch.isfinite(cut["render"]).all() and int(cut["overflow"]) == 0
    assert not torch.equal(cut["render"], base["render"])
