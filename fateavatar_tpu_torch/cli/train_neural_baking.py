"""Stage-3 neural baking CLI (train_neural_baking.py:18-141): bake a trained
avatar's Gaussians into continuous UV attribute maps.

Port of ``fateavatar_tpu/cli/train_neural_baking.py``. Runs on the card
unless ``--device cpu`` is given.

Usage:
  python -m fateavatar_tpu_torch.cli.train_neural_baking \\
      --config configs/fateavatar.yaml --workspace ./ws/obama \\
      --decode_type UNet --bake_attribute color opacity \\
      dataset.root_path=/data/insta/obama
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--workspace", type=str, required=True,
                        help="workspace of the trained avatar")
    parser.add_argument("--decode_type", type=str, default="UNet",
                        choices=["UNet", "decode_only", "feature_map"])
    parser.add_argument("--bake_attribute", nargs="+",
                        default=["color", "opacity"])
    parser.add_argument("--reg_weight", type=float, default=0.0)
    parser.add_argument("--reg_attribute", nargs="+", default=["color"])
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to bake on (default cuda)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.models import uv_decoder as uvd
    from fateavatar_tpu_torch.train.baker import UVBaker
    from fateavatar_tpu_torch.train.loader import Loader
    from fateavatar_tpu_torch.utils.config import load_config

    cfg = load_config(args.config, args.overrides)
    cfg.workspace = args.workspace
    dev = args.device

    train_ds, _ = common.construct_datasets(cfg)
    flame = common.construct_flame(cfg, train_ds, device=dev)
    model, params0, state0 = common.construct_model(cfg, flame, device=dev)

    loader = Loader(model, params0, state0, args.workspace,
                    render_cfg=common.render_config(cfg))

    dec_model, net, const = uvd.build_uv_decoder(
        model, loader.params, loader.state,
        decode_type=args.decode_type,
        bake_attribute=tuple(args.bake_attribute),
    )
    loss_fn = common.construct_loss(cfg, device=dev)
    baker = UVBaker(
        dec_model, net, const, loss_fn, train_ds,
        workspace=args.workspace,
        reg_weight=args.reg_weight, reg_attribute=args.reg_attribute,
        render_cfg=common.render_config(cfg),
    )
    baker.bake(args.epochs)
    baker.texture_dump()
    baker.export_avatar()
    print(f"baked avatar + textures written under {args.workspace}")
    return baker


if __name__ == "__main__":
    main()
