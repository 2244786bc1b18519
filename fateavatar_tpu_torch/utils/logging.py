"""Console + append-only file logging, and the image and video writers.

Port of ``fateavatar_tpu/utils/logging.py``. The writers need neither PIL
nor OpenCV: PNGs go through the port's own codec (``utils/png.py``), and
``write_video`` pipes raw frames to the ``ffmpeg`` binary when there is one,
else writes an animated GIF itself (:func:`write_gif`) as the JAX package's
fallback has PIL write it: median-cut palettes, delta frames, LZW.
"""

from __future__ import annotations

import datetime
import os
import shutil
import struct
import subprocess
import sys
from typing import Optional

import numpy as np

from fateavatar_tpu_torch.utils.png import write_png

# the GIF fallback: at most this many colours a frame (an 8-bit table)
GIF_COLORS = 256
# LZW codes are at most 12 bits: 4096 table entries before a clear code
_LZW_MAX = 4096


class Logger:
    def __init__(self, name: str, workspace: Optional[str] = None,
                 quiet: bool = False):
        self.name = name
        self.quiet = quiet
        self.ptr = None
        if workspace is not None:
            os.makedirs(workspace, exist_ok=True)
            self.ptr = open(os.path.join(workspace, f"log_{name}.txt"), "a+")

    def log(self, *args):
        msg = " ".join(str(a) for a in args)
        if not self.quiet:
            print(msg, file=sys.stderr)
        self.file_only(msg)

    def file_only(self, *args):
        if self.ptr:
            stamp = datetime.datetime.now().strftime("%H:%M:%S")
            print(f"[{stamp}]", *args, file=self.ptr)
            self.ptr.flush()

    def close(self):
        if self.ptr:
            self.ptr.close()
            self.ptr = None


def _u8(img) -> np.ndarray:
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        return arr
    return (np.clip(arr, 0, 1) * 255).astype("uint8")


def save_image(path: str, img) -> None:
    """[H, W, 3] float [0,1] (or uint8) -> PNG."""
    write_png(path, _u8(img))


def save_image_grid(path: str, images, cols: Optional[int] = None) -> None:
    """List of [H, W, 3] floats -> one grid PNG (tools/util.py:171 equivalent)."""
    imgs = [np.clip(np.asarray(i), 0, 1) for i in images]
    n = len(imgs)
    cols = cols or n
    rows = (n + cols - 1) // cols
    h, w = imgs[0].shape[:2]
    grid = np.ones((rows * h, cols * w, 3), np.float32)
    for i, im in enumerate(imgs):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    save_image(path, grid)


def median_cut(colors: np.ndarray, counts: np.ndarray, n: int = GIF_COLORS) -> np.ndarray:
    """Median cut of the distinct ``colors`` [U, 3] seen ``counts`` times
    each into at most ``n`` boxes, as Pillow quantizes for its ADAPTIVE
    palette (Quant.c): the box with the most pixels is split along its
    widest channel at the value where its pixels' cumulative count passes
    half (the colours of that value on the side that keeps both non-empty),
    until ``n`` boxes or none with two colours is left. Returns each
    colour's box, int64 [U]."""
    ct = np.ascontiguousarray(colors.T, np.int64)      # [3, U]: a channel a row
    counts = counts.astype(np.int64)
    boxes = [np.arange(len(counts))]
    weight = np.zeros(n, np.int64)
    weight[0] = counts.sum()
    split = np.zeros(n, bool)             # whether a box holds two colours
    split[0] = len(counts) > 1
    while len(boxes) < n and split[:len(boxes)].any():
        i = int(np.argmax(np.where(split[:len(boxes)], weight[:len(boxes)], -1)))
        box = boxes[i]
        c = ct[:, box]
        lo, hi = c.min(1), c.max(1)
        axis = int(np.argmax(hi - lo))
        hist = np.cumsum(np.bincount(c[axis], weights=counts[box], minlength=256))
        m = int(np.searchsorted(hist, hist[-1] / 2))
        m = min(max(m, int(lo[axis])), int(hi[axis]) - 1)   # values <= m left: both non-empty
        left = c[axis] <= m
        boxes[i] = box[left]
        boxes.append(box[~left])
        weight[i], weight[len(boxes) - 1] = hist[m], hist[-1] - hist[m]
        split[i], split[len(boxes) - 1] = len(boxes[i]) > 1, len(boxes[-1]) > 1
    label = np.empty(len(counts), np.int64)
    for j, b in enumerate(boxes):
        label[b] = j
    return label


def nearest_entry(colors: np.ndarray, palette: np.ndarray, chunk: int = 1 << 15) -> np.ndarray:
    """The index of the palette entry nearest each colour [U, 3] in squared
    RGB distance (no dithering; the lowest index on a tie): |p|^2 - 2 c.p
    for every entry, integers below 2^24, so exact in float32."""
    pal = palette.astype(np.float32)
    p2 = (pal ** 2).sum(1)
    out = np.empty(len(colors), np.int64)
    for s in range(0, len(colors), chunk):
        c = colors[s:s + chunk].astype(np.float32)
        out[s:s + chunk] = np.argmin(p2[None, :] - 2.0 * (c @ pal.T), axis=1)
    return out


# the distinct colours the median cut works on, at most: more, and the
# colours lose a bit a channel until they fit (Quant.c's pixel hash)
_CUT_COLORS = 1 << 16


def quantize_frame(frame: np.ndarray) -> tuple:
    """A uint8 [H, W, 3] frame as (indices uint8 [H, W], palette uint8 [k, 3]):
    the median-cut boxes of its colours (at reduced precision where it has
    over 65536), each box's entry its pixels' mean colour, rounded, each
    pixel mapped to its nearest entry, the unused entries dropped."""
    packed = ((frame[..., 0].astype(np.int32) << 16) | (frame[..., 1].astype(np.int32) << 8)
              | frame[..., 2].astype(np.int32)).reshape(-1)
    uniq, inverse, counts = np.unique(packed, return_inverse=True, return_counts=True)
    colors = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], axis=1)
    shift, key = 0, uniq
    while True:
        rkey, rinv = np.unique(key, return_inverse=True)
        if len(rkey) <= _CUT_COLORS:
            break
        shift += 1
        key = (((colors >> shift) << np.array([16, 8, 0])).sum(1))
    rcolors = np.stack([rkey >> 16, (rkey >> 8) & 255, rkey & 255], axis=1)
    box = median_cut(rcolors, np.bincount(rinv, weights=counts))[rinv]
    w = np.bincount(box, weights=counts)
    palette = np.stack([np.rint(np.bincount(box, weights=colors[:, ch] * counts) / w)
                        for ch in range(3)], axis=1).astype(np.uint8)
    entry = nearest_entry(colors, palette)
    used, entry = np.unique(entry, return_inverse=True)
    idx = entry[inverse].reshape(frame.shape[:2]).astype(np.uint8)
    return idx, palette[used]


def lzw_codes(data: np.ndarray, min_size: int) -> tuple:
    """GIF's variable-length LZW of a byte stream: (codes, widths) as int64
    arrays. The first code is a clear; the table grows from
    ``2**min_size + 2`` entries, a clear code resets it when it is full
    (4096 entries), and the end code is last. Each code is written with the
    width the decoder reads it at: the k-th code after a clear is read once
    the decoder's table holds ``2**min_size + k`` entries, so it takes
    their bit length (``min_size + 1`` bits at first, 12 at most).

    The codes are those of the plain one-symbol-at-a-time encoder; a run of
    one value is taken in steps of whole table strings: the strings of a
    value repeated 1, 2, ... K times are added in that order, so inside a
    run the longest match is known without a lookup a symbol."""
    clear = 1 << min_size
    first = clear + 2
    codes = [clear]
    emit = codes.append
    table: dict = {}
    get = table.get
    runs: dict = {}                     # value -> codes of value * 1, 2, ... K
    nxt = first
    raw = np.ascontiguousarray(data, np.uint8).reshape(-1)
    # the stream as runs of one value: (value, length)
    ends = np.r_[np.flatnonzero(raw[1:] != raw[:-1]) + 1, raw.size]
    lens = np.diff(np.r_[0, ends])
    vals = raw[ends - lens].tolist()
    lens = lens.tolist()
    lens[0] -= 1
    # the prefix string is run_val * run_len when run_len > 0
    prefix = run_val = vals[0]
    run_len = 1
    for v, r in zip(vals, lens):
        while r:
            if run_len and run_val == v:
                chain = runs.get(v)
                if chain is None:
                    chain = runs[v] = [v]
                K = len(chain)
                if run_len + r <= K:     # the rest of the run matches one string
                    run_len += r
                    prefix = chain[run_len - 1]
                    break
                r -= K - run_len + 1     # the longest string, then one more symbol
                emit(chain[K - 1])
                if nxt == _LZW_MAX - 1:
                    emit(clear)
                    table.clear()
                    runs.clear()
                    nxt = first
                else:
                    table[(chain[K - 1] << 8) | v] = nxt
                    chain.append(nxt)
                    nxt += 1
                prefix, run_len = v, 1
                continue
            key = (prefix << 8) | v
            code = get(key)
            r -= 1
            if code is not None:
                prefix, run_len = code, 0
                continue
            emit(prefix)
            if nxt == _LZW_MAX - 1:      # this entry fills the table
                emit(clear)
                table.clear()
                runs.clear()
                nxt = first
            else:
                table[key] = nxt
                nxt += 1
            prefix, run_val, run_len = v, v, 1
    emit(prefix)
    emit(clear + 1)
    codes = np.asarray(codes, np.int64)
    pos = np.arange(len(codes))
    # each code's place after the last clear before it
    last_clear = np.maximum.accumulate(np.where(codes == clear, pos, 0))
    k = pos - np.r_[0, last_clear[:-1]]
    widths = np.frexp((first + k - 2).astype(np.float64))[1].astype(np.int64)
    widths[0] = min_size + 1
    return codes, widths


def _pack_lsb(codes: np.ndarray, widths: np.ndarray) -> bytes:
    """Codes of the given bit widths packed least significant bit first."""
    ends = np.cumsum(widths)
    shift = np.arange(int(ends[-1])) - np.repeat(ends - widths, widths)
    bits = ((np.repeat(codes, widths) >> shift) & 1).astype(np.uint8)
    return np.packbits(bits, bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def _table_bits(n: int) -> int:
    """Bits of the smallest colour table (2 entries at least) holding n."""
    return max(1, (n - 1).bit_length())


def write_gif(path: str, frames, fps: int = 25) -> None:
    """uint8 [H, W, 3] frames -> a looping animated GIF written as Pillow
    writes ``save(save_all=True)`` of RGB frames: each frame on its own
    median-cut palette of at most 256 colours (:func:`quantize_frame`), the
    first frame's as the global table; each later frame cropped to the box
    of pixels whose colour changed since the previous frame, with a local
    table, and where its table has room, the unchanged pixels in that box
    written as a transparent index; every image LZW-coded with 9- to 12-bit
    codes (:func:`lzw_codes`)."""
    h, w = frames[0].shape[:2]
    delay = max(1, round(100 / fps))                       # hundredths of a second
    prev = None
    with open(path, "wb") as f:
        for n, fr in enumerate(frames):
            fr = np.asarray(fr)[..., :3]
            idx, pal = quantize_frame(fr)
            rgb = pal[idx]
            box, transparent = (0, 0, w, h), None
            if prev is not None:
                changed = (rgb != prev).any(-1)
                if not changed.any():
                    prev = rgb
                    continue
                ys, xs = np.nonzero(changed.any(1))[0], np.nonzero(changed.any(0))[0]
                box = (int(xs[0]), int(ys[0]), int(xs[-1]) + 1, int(ys[-1]) + 1)
                if len(pal) < GIF_COLORS:
                    transparent = len(pal)
                    idx = np.where(changed, idx, transparent).astype(np.uint8)
                    pal = np.concatenate([pal, np.zeros((1, 3), np.uint8)])
            prev = rgb
            bits = _table_bits(len(pal))
            table = np.zeros((1 << bits, 3), np.uint8)
            table[:len(pal)] = pal
            if n == 0:
                f.write(b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF0 | (bits - 1), 0, 0))
                f.write(table.tobytes())
                # NETSCAPE2.0 extension: loop forever
                f.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00")
            flags = 0 if transparent is None else 1
            f.write(b"\x21\xf9\x04" + struct.pack("<BHBB", flags, delay, transparent or 0, 0))
            x0, y0, x1, y1 = box
            local = 0 if n == 0 else 0x80 | (bits - 1)
            f.write(b"\x2c" + struct.pack("<HHHHB", x0, y0, x1 - x0, y1 - y0, local))
            if n:
                f.write(table.tobytes())
            min_size = max(2, bits)
            codes, widths = lzw_codes(idx[y0:y1, x0:x1].reshape(-1), min_size)
            f.write(bytes([min_size]) + _sub_blocks(_pack_lsb(codes, widths)))
        f.write(b"\x3b")


def write_video(path: str, frames, fps: int = 25, crf: int = None,
                preset: str = None) -> bool:
    """Write an mp4 via the ffmpeg binary if present; else fall back to an
    animated GIF beside it (the reference uses cv2.VideoWriter,
    train/trainer.py:302).

    ``crf``/``preset`` select x264 quality — the NeRSemble submission
    encoding is crf=14 preset=slow (run_nersemble_benchmark.py:127-137)."""
    frames = [_u8(f) for f in frames]
    if shutil.which("ffmpeg") and path.endswith(".mp4"):
        h, w = frames[0].shape[:2]
        quality = []
        if crf is not None:
            quality += ["-crf", str(crf)]
        if preset is not None:
            quality += ["-preset", preset]
        proc = subprocess.Popen(
            ["ffmpeg", "-y", "-loglevel", "error", "-f", "rawvideo",
             "-pix_fmt", "rgb24", "-s", f"{w}x{h}", "-r", str(fps),
             "-i", "-", "-c:v", "libx264", "-pix_fmt", "yuv420p",
             *quality, path],
            stdin=subprocess.PIPE,
        )
        for f in frames:
            proc.stdin.write(f.tobytes())
        proc.stdin.close()
        proc.wait()
        return proc.returncode == 0
    write_gif(path.rsplit(".", 1)[0] + ".gif", frames, fps=fps)
    return True
