"""Train a registered baseline avatar family by name.

Port of ``fateavatar_tpu/cli/train_baseline.py`` (the reference reuses
train_mono_avatar.py with --model_name through train/callbacks.py; here a
CLI over ``train/registry.py`` and ``train/adapters.py`` drives the same
Trainer as the flagship: epochs, prefetch, meters, tracking, evaluation
media, checkpoints). Runs on the card unless ``--device cpu`` is given.

Usage:
  python -m fateavatar_tpu_torch.cli.train_baseline --model gaussianavatars \\
      dataset.root_path=/data/insta/obama workspace=./ws
  (--config defaults to configs/<model>.yaml where it exists; the run's
  workspace is <workspace>/baseline_<model>)
"""

from __future__ import annotations

import argparse
import os

FAMILIES = ("gaussianavatars", "flashavatar", "splattingavatar", "monogaussianavatar")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, required=True, choices=FAMILIES)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda)")
    parser.add_argument("overrides", nargs="*", help="key.path=value")
    return parser.parse_args(argv)


def build_trainer(args):
    """The family's model, loss, optimizer and adapter from the config, and
    the Trainer over the config's datasets (nothing trained yet)."""
    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.train import registry
    from fateavatar_tpu_torch.train.adapters import make_family_adapter
    from fateavatar_tpu_torch.train.trainer import Trainer
    from fateavatar_tpu_torch.utils.config import config_to_dict, load_config
    from fateavatar_tpu_torch.utils.obj_io import load_obj

    if args.config is None:
        default = os.path.join("configs", f"{args.model}.yaml")
        if os.path.exists(default):
            args.config = default
    cfg = load_config(args.config, args.overrides)
    train_ds, test_ds = common.construct_datasets(cfg)
    flame = common.construct_flame(cfg, train_ds, device=args.device)
    template = load_obj(cfg.assets.template_mesh_path)

    entry = registry.get(args.model)
    model_cfg = dict(config_to_dict(cfg.model))
    model_cfg.update(
        img_height=cfg.dataset.img_res[0], img_width=cfg.dataset.img_res[1],
        capacity=cfg.training.max_points_num, dataset_type=train_ds.type_name,
    )
    bundle = entry.build_model(template, flame, model_cfg)
    loss_fn = entry.build_loss(config_to_dict(cfg.loss), bundle)
    opt = entry.build_optimizer(config_to_dict(cfg.training))
    render_cfg = common.render_config(cfg)
    adapter = make_family_adapter(args.model, bundle, loss_fn, opt, render_cfg,
                                  config_to_dict(cfg.training))
    state0 = bundle[2] if len(bundle) > 2 and not callable(bundle[2]) else None
    return Trainer(
        name=args.model,
        model=bundle[0],
        params=bundle[1],
        state=state0,
        loss_fn=loss_fn,
        optimizer=opt,
        train_dataset=train_ds,
        test_dataset=test_ds,
        workspace=os.path.join(cfg.workspace, f"baseline_{args.model}"),
        render_cfg=render_cfg,
        tracking_lr=cfg.training.tracking_lr,
        seed=cfg.seed,
        adapter=adapter,
    )


def main(argv=None):
    args = parse_args(argv)
    trainer = build_trainer(args)
    if args.resume:
        trainer.load_checkpoint()
    trainer.train(args.epochs)
    if trainer.test_dataset is not None and len(trainer.test_dataset):
        trainer.evaluate("test")
    return trainer


if __name__ == "__main__":
    main()
