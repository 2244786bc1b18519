"""PNG codec and the loader's bilinear resize, on numpy and ``zlib``.

The port's counterpart of the JAX package's native loader
(``fateavatar_tpu/native/loader.cc`` behind ``native.decode_image``), for
machines that have neither PIL nor the libpng headers. Decoding applies the
transforms ``loader.cc`` asks libpng for: 16-bit samples keep their high
byte, palettes expand to RGB, a tRNS chunk becomes an alpha channel, and
grey expands to RGB. So a decoded image has 3 or 4 channels of uint8.
PNGs of every colour type and bit depth are read, Adam7-interlaced ones
too (each of the 7 passes unfiltered on its own and scattered into the
image, as libpng's ``png_read_image`` does). :func:`read_image` picks the
codec by the file's magic bytes: PNG here, JPEG in ``utils/jpeg.py``;
anything else raises ``ValueError`` naming the file.
:func:`resize_to_rgba` is ``resize_to_rgba`` of ``loader.cc`` with the same
float32 operations in the same order; :func:`resize_bicubic_u8` is PIL's
default ``Image.resize`` of a grey image (bicubic, fixed point), for the
masks. :func:`write_png` / :func:`encode_png` write 8-bit grey, RGB or RGBA
with filter 0.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7's passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG has no IEND chunk")


def _unfilter_wavefront(filt: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Undo rows of any filter types at once. A pixel's reconstruction needs
    its left, upper and upper-left neighbours only, so all pixels of one
    anti-diagonal (x + y = d) depend on earlier diagonals alone: one
    vectorized step per diagonal, H + W - 1 steps."""
    h, stride = filt.shape
    w = stride // bpp
    row = w + 1                                   # out has a zero top row and left column
    f = filt.reshape(h * w, bpp).astype(np.int16)
    out = np.zeros(((h + 1) * row, bpp), np.int16)
    ty = kinds.astype(np.int16)
    has_avg, has_paeth = bool((kinds == 3).any()), bool((kinds == 4).any())
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        o = (y + 1) * row + (d - y) + 1           # flat index of pixel (y, d - y) in out
        a, b, c = out[o - 1], out[o - row], out[o - row - 1]    # left, up, up-left
        t = ty[y][:, None]
        pred = np.where(t == 1, a, np.where(t == 2, b, 0))
        if has_avg:
            pred = np.where(t == 3, (a + b) >> 1, pred)
        if has_paeth:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where(t == 4, np.where((pa <= pb) & (pa <= pc), a,
                                             np.where(pb <= pc, b, c)), pred)
        out[o] = (f[y * w + d - y] + pred) & 0xFF
    return out.reshape(h + 1, row, bpp)[1:, 1:].reshape(h, stride).astype(np.uint8)


def _unfilter(raw, height: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo the per-row filters: [height, stride] uint8. Images with only
    None, Sub and Up rows go row by row, each row vectorized; Avg and Paeth
    depend on the reconstructed left neighbour, and an image with such rows
    goes by anti-diagonals (:func:`_unfilter_wavefront`)."""
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{path}: PNG image data too short")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    kinds, filt = rows[:, 0], rows[:, 1:]
    if kinds.size and int(kinds.max()) > 4:
        raise ValueError(f"{path}: unknown PNG filter type {int(kinds.max())}")
    if stride % bpp:
        raise ValueError(f"{path}: row length not a multiple of the pixel size")
    if (kinds >= 3).any():
        return _unfilter_wavefront(filt, kinds, bpp)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        line = filt[y]
        if kinds[y] == 1:    # Sub: a running sum mod 256 along each byte lane
            line = np.cumsum(line.reshape(-1, bpp), axis=0,
                             dtype=np.uint64).astype(np.uint8).reshape(-1)
        elif kinds[y] == 2:  # Up
            line = line + prev
        out[y] = line
        prev = out[y]
    return out


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows -> [H, W, channels] integer samples at their depth."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(h, width, channels).astype(np.uint16)
    if depth == 8:
        return rows.reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth]      # one channel
    bits = bits.reshape(h, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[..., None]


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file to uint8 [H, W, 3] or [H, W, 4] (RGB, or RGBA when
    the file has alpha or a tRNS chunk), as ``loader.cc``'s libpng
    transforms give it."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if interlace not in (0, 1):
        raise ValueError(f"{path}: unknown PNG interlace method {interlace}")
    if color not in _SAMPLES or depth not in (1, 2, 4, 8, 16) or (
            depth < 8 and color not in (0, 3)) or (depth == 16 and color == 3):
        raise ValueError(f"{path}: invalid PNG colour type {color} at depth {depth}")
    channels = _SAMPLES[color]
    bpp = max(1, channels * depth // 8)
    raw = zlib.decompress(b"".join(idat))
    if interlace == 0:
        stride = (width * channels * depth + 7) // 8
        s = _samples(_unfilter(raw, height, stride, bpp, path), width, channels, depth)
    else:
        s = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue                 # an empty pass has no bytes at all
            stride = (pw * channels * depth + 7) // 8
            rows = _unfilter(memoryview(raw)[pos:], ph, stride, bpp, path)
            s[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
            pos += ph * (stride + 1)

    alpha = None
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        idx = s[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
        rgb = palette[idx]
        if trns is not None:
            table = np.full(256, 255, np.uint8)
            table[:len(trns)] = np.frombuffer(trns, np.uint8)
            alpha = table[idx]
        return rgb if alpha is None else np.concatenate([rgb, alpha[..., None]], axis=-1)

    if trns is not None and color in (0, 2):
        key = np.frombuffer(trns, ">u2")[:channels].astype(np.uint16)
        alpha = np.where((s == key).all(axis=-1), 0, 255).astype(np.uint8)
    if depth == 16:
        s = (s >> 8).astype(np.uint8)
    elif depth < 8:                      # grey 1/2/4 bits scaled to 8
        s = (s * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if color in (0, 4):                  # grey (+ alpha) -> RGB (+ alpha)
        s = np.concatenate([np.repeat(s[..., :1], 3, axis=-1), s[..., 1:]], axis=-1)
    if alpha is not None:
        s = np.concatenate([s, alpha[..., None]], axis=-1)
    return np.ascontiguousarray(s)


def resize_to_rgba(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Bilinear resize (align-corners=false) of uint8 [H, W, C] to float32
    RGBA [height, width, 4] in [0, 1]; channels past C are 1.0. The float32
    operations of ``loader.cc``'s ``resize_to_rgba``, in its order."""
    f32 = np.float32
    ih, iw, c = img.shape

    def axis(n_out, n_in):
        scale = f32(n_in) / f32(n_out)
        pos = (np.arange(n_out, dtype=f32) + f32(0.5)) * scale - f32(0.5)
        i0 = np.floor(pos).astype(np.int64)
        frac = pos - i0.astype(f32)
        i1 = np.clip(i0 + 1, 0, n_in - 1)
        return np.clip(i0, 0, n_in - 1), i1, frac.astype(f32)

    y0, y1, wy = axis(height, ih)
    x0, x1, wx = axis(width, iw)
    src = img.astype(f32)
    wx, wy = wx[None, :, None], wy[:, None, None]
    one = f32(1)
    top = src[y0][:, x0] * (one - wx) + src[y0][:, x1] * wx
    bot = src[y1][:, x0] * (one - wx) + src[y1][:, x1] * wx
    v = (top * (one - wy) + bot * wy) * (f32(1.0) / f32(255.0))
    out = np.ones((height, width, 4), f32)
    out[..., :c] = v[..., :4]
    return out


# PIL's 8-bit resampling (libImaging/Resample.c): coefficients in fixed
# point with 22 fractional bits, rounding, clipping to [0, 255]
_PRECISION_BITS = 22


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _pil_taps(n_in: int, n_out: int):
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    bicubic filter: (source index [n_out, k], int64 weight [n_out, k])."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((n_out, ksize), np.int64)
    wts = np.zeros((n_out, ksize), np.int64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        w = _bicubic((np.arange(xmax) + xmin - center + 0.5) / filterscale)
        ww = w.sum()
        if ww != 0.0:
            w = w / ww
        idx[xx, :xmax] = xmin + np.arange(xmax)
        wts[xx, :xmax] = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << _PRECISION_BITS))
    return idx, wts


def _resample_rows(img: np.ndarray, n_out: int) -> np.ndarray:
    """One pass along axis 1 of uint8 [H, W] (PIL's ImagingResampleHorizontal
    / Vertical_8bpc)."""
    idx, wts = _pil_taps(img.shape[1], n_out)
    acc = np.full((img.shape[0], n_out), 1 << (_PRECISION_BITS - 1), np.int64)
    src = img.astype(np.int64)
    for k in range(idx.shape[1]):
        acc += src[:, idx[:, k]] * wts[:, k]
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's ``Image.resize((width, height))`` of a grey uint8 [H, W] image
    with its default filter (bicubic, a = -0.5, support scaled when
    shrinking): the horizontal pass, then the vertical, each rounded to
    uint8, as PIL does. Bit-exact with PIL."""
    out = img
    if width != img.shape[1]:
        out = _resample_rows(out, width)
    if height != img.shape[0]:
        out = _resample_rows(out.T, height).T
    return np.ascontiguousarray(out)


def read_image(path: str) -> np.ndarray:
    """Decode a PNG (:func:`read_png`) or a JPEG (``utils/jpeg.read_jpeg``,
    RGB), chosen by the file's magic bytes as ``loader.cc`` chooses;
    another format raises ``ValueError`` naming the file."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic[:2] == b"\x89P":
        return read_png(path)
    if magic[:2] == b"\xff\xd8":
        from fateavatar_tpu_torch.utils import jpeg

        return jpeg.read_jpeg(path)
    raise ValueError(f"{path}: neither PNG nor JPEG")


def decode_image(path: str, width: int, height: int):
    """Decode and resize one image: (rgba float32 [height, width, 4], source
    channel count 3 or 4), as ``native.decode_image`` returns it."""
    img = read_image(path)
    return resize_to_rgba(img, width, height), img.shape[2]


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W], [H, W, 1], [H, W, 3] or [H, W, 4] as the bytes of an
    8-bit grey, RGB or RGBA PNG, every row with filter 0."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        raise ValueError(f"a PNG is written from uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color = {1: 0, 3: 2, 4: 6}.get(c)
    if color is None:
        raise ValueError(f"a PNG is written from 1, 3 or 4 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(arr).reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)

    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 [H, W], [H, W, 1], [H, W, 3] or [H, W, 4] as an 8-bit
    grey, RGB or RGBA PNG (:func:`encode_png`)."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
