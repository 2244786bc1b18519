"""Time the PyTorch port's JPEG encoder (``utils/jpeg.encode_jpeg``).

Renders nothing: one seeded 512x512 frame shaped like the viewer's (a white
background and a shaded, lightly noisy disc) is encoded at quality 90 on
``--device`` (default ``cuda``). Prints one JSON object: milliseconds per
call (median of ``--reps``, host clock, synchronized) of the whole encode,
of its device half (``jpeg_coefficients`` up to the coefficients' host
copy) and of its host half (the entropy coding), the device half's CUDA
event time and the kernels it launches (torch.profiler), the PNG encode of
the same frame for scale, and, where PIL is installed, Pillow's encode and
whether its bytes equal the port's.

    python scripts/time_jpeg_encode.py --device cuda
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fateavatar_tpu_torch.utils import jpeg  # noqa: E402
from fateavatar_tpu_torch.utils.png import encode_png  # noqa: E402


def viewer_like(size: int, seed: int) -> np.ndarray:
    """A [size, size, 3] uint8 frame: white, with a shaded disc whose
    colours carry a little noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size] / size
    img = np.ones((size, size, 3))
    head = (xx - 0.5) ** 2 + (yy - 0.45) ** 2 < 0.09
    shade = np.stack([0.8 * np.sin(xx * 9) ** 2, 0.6 + 0.2 * yy, 0.5 * xx], -1)
    img[head] = shade[head] + rng.normal(0, 0.02, (int(head.sum()), 3))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--quality", type=int, default=90)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    host = viewer_like(args.size, 0)
    frame = torch.from_numpy(host).to(dev)
    q = args.quality

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def median_ms(fn):
        fn()
        ts = []
        for _ in range(args.reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    coefs = jpeg.jpeg_coefficients(frame, q).cpu().numpy()
    out = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "size": args.size, "quality": q,
           "encode_ms": median_ms(lambda: jpeg.encode_jpeg(frame, q)),
           "device_half_ms": median_ms(lambda: jpeg.jpeg_coefficients(frame, q).cpu()),
           "host_half_ms": median_ms(lambda: jpeg._entropy_code(coefs)),
           "png_ms": median_ms(lambda: encode_png(host)),
           "bytes": len(jpeg.encode_jpeg(frame, q))}
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(args.reps):
            jpeg.jpeg_coefficients(frame, q)
        ev[1].record()
        sync()
        out["device_half_event_ms"] = ev[0].elapsed_time(ev[1]) / args.reps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            jpeg.jpeg_coefficients(frame, q)
            sync()
        kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        out["device_half_kernels"] = sum(e.count for e in kernels)
        out["device_half_kernel_ms"] = sum(e.self_device_time_total for e in kernels) / 1e3
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        def pil():
            buf = io.BytesIO()
            Image.fromarray(host).save(buf, format="JPEG", quality=q)
            return buf.getvalue()

        out["pil_ms"] = median_ms(pil)
        out["pil_bytes_equal"] = pil() == jpeg.encode_jpeg(frame, q)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
