"""Time the PyTorch port's numpy JPEG decoder against libjpeg.

Writes one seeded photo-like RGB frame as a JPEG with PIL (4:2:0 by
default, as cameras and ``PIL.Image.save`` write them), then times
``fateavatar_tpu_torch.utils.jpeg.decode_jpeg`` and PIL's libjpeg decode of
the same bytes, and the port's PNG decoder on the same frame as a PNG.
Prints one JSON object (milliseconds per decode, the best of ``--reps``).

    PYTHONPATH=. python scripts/time_jpeg_decode.py --size 512 --quality 90

PIL is needed only to encode the frames; the times are the host CPU's.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import tempfile
import time

import numpy as np
from PIL import Image

from fateavatar_tpu_torch.utils import jpeg, png

SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def photo_like(size: int, seed: int) -> np.ndarray:
    """A [size, size, 3] uint8 frame: smooth colour fields (bilinear from a
    coarse seeded grid) with edges and a little sensor noise."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (9, 9, 3))
    t = np.linspace(0, 8, size)
    i0 = np.minimum(t.astype(int), 7)
    f = (t - i0)[:, None, None]
    rows = coarse[i0] * (1 - f) + coarse[i0 + 1] * f
    fx = f.reshape(1, -1, 1)
    img = rows[:, i0] * (1 - fx) + rows[:, i0 + 1] * fx
    yy, xx = np.mgrid[:size, :size]
    img += 40.0 * (((xx // 37 + yy // 53) % 2) - 0.5)[..., None]
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def best_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--quality", type=int, default=90)
    ap.add_argument("--subsampling", choices=sorted(SUBSAMPLING), default="4:2:0")
    ap.add_argument("--progressive", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    img = photo_like(args.size, args.seed)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=args.quality,
                              subsampling=SUBSAMPLING[args.subsampling],
                              progressive=args.progressive)
    data = buf.getvalue()
    tmp = tempfile.mkdtemp()
    png_path = os.path.join(tmp, "frame.png")
    Image.fromarray(img).save(png_path)

    ours = jpeg.decode_jpeg(data)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    print(json.dumps({
        "size": args.size, "quality": args.quality, "subsampling": args.subsampling,
        "progressive": args.progressive, "jpeg_bytes": len(data),
        "max_abs_diff_vs_pil": int(np.abs(ours.astype(int) - ref.astype(int)).max()),
        "port_jpeg_ms": best_ms(lambda: jpeg.decode_jpeg(data), args.reps),
        "pil_libjpeg_ms": best_ms(
            lambda: np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), args.reps),
        "port_png_ms": best_ms(lambda: png.read_png(png_path), args.reps),
        "reps": args.reps,
    }))
    os.remove(png_path)
    os.rmdir(tmp)


if __name__ == "__main__":
    main()
