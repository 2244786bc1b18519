"""Console + append-only file logging, and the image and video writers.

Port of ``fateavatar_tpu/utils/logging.py``. The writers need neither PIL
nor OpenCV: PNGs go through the port's own codec (``utils/png.py``), and
``write_video`` pipes raw frames to the ``ffmpeg`` binary when there is one,
else writes an animated GIF itself (:func:`write_gif`).
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

# the GIF fallback's fixed palette: 6 levels per channel (step 51), 216
# colours, padded to the 256 entries of an 8-bit colour table
GIF_LEVELS = 6
GIF_STEP = 255 // (GIF_LEVELS - 1)
# literal codes between clear codes: the decoder's table then never grows
# past 9-bit codes (258 + 250 < 512)
_GIF_RUN = 250


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


def _gif_palette() -> bytes:
    lv = np.arange(GIF_LEVELS) * GIF_STEP
    r, g, b = np.meshgrid(lv, lv, lv, indexing="ij")
    table = np.zeros((256, 3), np.uint8)
    table[:GIF_LEVELS ** 3] = np.stack([r.ravel(), g.ravel(), b.ravel()], axis=1)
    return table.tobytes()


def _gif_image_data(frame: np.ndarray) -> bytes:
    """One frame's LZW stream (minimum code size 8) as GIF sub-blocks: each
    pixel a literal 9-bit code of its nearest palette colour, a clear code
    before every run of _GIF_RUN pixels, the end code last. Uncompressed,
    but any GIF decoder reads it, and it packs with numpy alone."""
    q = (frame.astype(np.uint16) + GIF_STEP // 2) // GIF_STEP           # [H, W, 3]
    idx = (q[..., 0] * GIF_LEVELS + q[..., 1]) * GIF_LEVELS + q[..., 2]
    idx = idx.reshape(-1)
    n = idx.size
    runs = -(-n // _GIF_RUN)
    codes = np.full(runs * (_GIF_RUN + 1) + 1, 0xFFFF, np.uint16)
    body = codes[:-1].reshape(runs, _GIF_RUN + 1)
    body[:, 0] = 256                                       # clear
    flat = np.full(runs * _GIF_RUN, 0xFFFF, np.uint16)
    flat[:n] = idx
    body[:, 1:] = flat.reshape(runs, _GIF_RUN)
    codes[-1] = 257                                        # end of information
    codes = codes[codes != 0xFFFF]
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(np.uint8)
    data = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return bytes([8]) + blocks + b"\x00"


def write_gif(path: str, frames, fps: int = 25) -> None:
    """uint8 [H, W, 3] frames -> a looping animated GIF on a fixed 216-colour
    palette (each channel rounded to the nearest multiple of GIF_STEP)."""
    h, w = frames[0].shape[:2]
    delay = max(1, round(100 / fps))                       # hundredths of a second
    with open(path, "wb") as f:
        f.write(b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0))
        f.write(_gif_palette())
        # NETSCAPE2.0 extension: loop forever
        f.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00")
        for fr in frames:
            f.write(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
            f.write(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
            f.write(_gif_image_data(np.asarray(fr)[..., :3]))
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
