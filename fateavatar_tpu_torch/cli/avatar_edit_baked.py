"""Sticker & style-transfer editing of a baked avatar
(avatar_edit_baked.py:18-123).

Port of ``fateavatar_tpu/cli/avatar_edit_baked.py``. Runs on the card
unless ``--device cpu`` is given. The videos are GIFs where there is no
ffmpeg (``utils/logging.write_video``).

Usage:
  python -m fateavatar_tpu_torch.cli.avatar_edit_baked \\
      --config configs/fateavatar.yaml --workspace ./ws/obama \\
      --sticker edit_assets/lty_content.png --sticker_mask edit_assets/lty_mask.png \\
      --style edit_assets/style_transfer/the_wave.t7 \\
      dataset.root_path=/data/insta/obama
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--workspace", type=str, required=True)
    parser.add_argument("--sticker", type=str, default=None)
    parser.add_argument("--sticker_mask", type=str, default=None)
    parser.add_argument("--sticker_pos", type=int, nargs=2, default=(128, 128))
    parser.add_argument("--sticker_scale", type=float, default=1.0)
    parser.add_argument("--style", type=str, default=None,
                        help="OpenCV .t7 fast-style-transfer model")
    parser.add_argument("--max_frames", type=int, default=100)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (default cuda)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    import torch
    from PIL import Image

    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.models import uv_decoder as uvd
    from fateavatar_tpu_torch.train.baker import UVEditor
    from fateavatar_tpu_torch.train.loader import Loader
    from fateavatar_tpu_torch.utils.config import load_config

    cfg = load_config(args.config, args.overrides)
    cfg.workspace = args.workspace
    dev = args.device

    train_ds, test_ds = common.construct_datasets(cfg)
    flame = common.construct_flame(cfg, train_ds, device=dev)
    model, params0, state0 = common.construct_model(cfg, flame, device=dev)
    loader = Loader(model, params0, state0, args.workspace,
                    render_cfg=common.render_config(cfg))
    dec_model, _, _ = uvd.build_uv_decoder(model, loader.params, loader.state)

    # latest dumped texture
    textures = sorted(glob.glob(
        os.path.join(args.workspace, "textures", "texture_epoch*.npz")
    ))
    if not textures:
        raise FileNotFoundError(
            f"no baked textures under {args.workspace}/textures — run "
            "train_neural_baking first"
        )
    with np.load(textures[-1]) as data:
        raw = {k: torch.from_numpy(data[k]).to(dev) for k in data.files}

    editor = UVEditor(dec_model, raw, render_cfg=common.render_config(cfg))

    media = os.path.join(args.workspace, "media")
    os.makedirs(media, exist_ok=True)

    if args.sticker is not None:
        sticker = np.asarray(Image.open(args.sticker).convert("RGB")) / 255.0
        if args.sticker_mask:
            mask = np.asarray(Image.open(args.sticker_mask).convert("L")) / 255.0
        else:
            mask = np.ones(sticker.shape[:2], np.float32)
        editor.sticker_editing(
            sticker.astype(np.float32), mask.astype(np.float32),
            position=tuple(args.sticker_pos), scale=args.sticker_scale,
        )
        editor.run_animation(
            test_ds, os.path.join(media, "edit_sticker.mp4"),
            max_frames=args.max_frames,
        )
        print("sticker edit video written")

    if args.style is not None:
        editor.style_transfer(args.style)
        editor.run_animation(
            test_ds, os.path.join(media, "edit_style.mp4"),
            max_frames=args.max_frames,
        )
        print("style transfer video written")
    return editor


if __name__ == "__main__":
    main()
