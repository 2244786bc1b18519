"""Stage-2b full-head fine-tune CLI (train_full_avatar.py:18-110): re-seed
the template splats, fine-tune on real and pseudo frames interleaved, and
write the orbit videos and the full-head checkpoint.

Port of ``fateavatar_tpu/cli/train_full_avatar.py``. Runs on the card unless
``--device cpu`` is given.

Usage:
  python -m fateavatar_tpu_torch.cli.train_full_avatar \\
      --config configs/fateavatar.yaml --workspace ./ws/obama \\
      dataset.root_path=/data/insta/obama
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--workspace", type=str, required=True)
    parser.add_argument("--finetune_epochs", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.completion.trainer import CompletionTrainer, PseudoDataset
    from fateavatar_tpu_torch.train.optim import fateavatar_optimizers
    from fateavatar_tpu_torch.utils.config import config_to_dict, load_config

    cfg = load_config(args.config, args.overrides)
    cfg.workspace = args.workspace
    dev = args.device

    identity = common.load_identity_info(args.workspace)
    train_ds, test_ds = common.construct_datasets(cfg)
    flame = common.construct_flame(cfg, train_ds, device=dev)
    model, params, state = common.construct_model(cfg, flame, device=dev)
    loss_fn = common.construct_loss(cfg, faces=model.faces, device=dev)
    optimizer = fateavatar_optimizers(config_to_dict(cfg.training))

    pseudo = PseudoDataset(
        os.path.join(args.workspace, "pseudo"),
        img_res=cfg.dataset.img_res,
        n_exp=train_ds.n_exp,
        flame_canonical_exp=flame.canonical_exp.cpu().numpy(),
        flame_canonical_pose=flame.canonical_pose.cpu().numpy(),
        fovx=identity["fovx"], fovy=identity["fovy"],
    )

    trainer = CompletionTrainer(
        name=cfg.name + "_fullhead",
        model=model, params=params, state=state,
        loss_fn=loss_fn, optimizer=optimizer,
        train_dataset=train_ds, test_dataset=test_ds,
        workspace=args.workspace,
        maint_cfg=common.maintenance_config(cfg),
        render_cfg=common.render_config(cfg),
        pseudo_dataset=pseudo,
    )
    trainer.load_checkpoint()
    trainer.add_default_points()
    trainer.augmentation(args.finetune_epochs)

    media = os.path.join(args.workspace, "media")
    trainer.render_dynamic_novel_view(os.path.join(media, "fullhead_orbit.mp4"))
    trainer.render_dynamic_fixed_view(os.path.join(media, "fixed_views"))
    print("full-head avatar trained; orbit videos written")
    return trainer


if __name__ == "__main__":
    main()
