"""Stage-1 monocular avatar training CLI (train_mono_avatar.py:18-97).

Port of ``fateavatar_tpu/cli/train_mono_avatar.py``. Runs on the card unless
``--device cpu`` is given.

Usage:
  python -m fateavatar_tpu_torch.cli.train_mono_avatar --config configs/fateavatar.yaml \\
      dataset.root_path=/data/insta/obama workspace=./ws/obama

Data parallel over N ranks (``--dp N``, N > 1): one process per rank, e.g.
  torchrun --nproc-per-node N -m fateavatar_tpu_torch.cli.train_mono_avatar \\
      --dp N --config ... (on one card, or on the CPU with --device cpu: gloo)
A process group of another size raises; ``--dp`` 0 or 1 trains on one
device.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--dp", type=int, default=0,
                        help="data parallel over N ranks, one process each (launch with "
                             "torchrun --nproc-per-node N); 0 or 1: one device")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda)")
    parser.add_argument("overrides", nargs="*", help="key.path=value")
    args = parser.parse_args(argv)

    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.train.optim import fateavatar_optimizers
    from fateavatar_tpu_torch.train.trainer import Trainer
    from fateavatar_tpu_torch.utils.config import config_to_dict, load_config
    from fateavatar_tpu_torch.utils.misc import file_backup, seed_everything

    cfg = load_config(args.config, args.overrides)
    dev = args.device
    mesh = None
    if args.dp > 1:
        from fateavatar_tpu_torch.parallel import make_device_mesh

        # raises, with how to launch, unless this is one of --dp ranks
        mesh = make_device_mesh(args.dp, device=dev)
        dev = str(mesh.device)
    main_rank = mesh is None or mesh.is_main

    seed_everything(cfg.seed)
    if main_rank:
        file_backup(cfg.workspace)  # reproducibility source snapshot

    train_ds, test_ds = common.construct_datasets(cfg)
    flame = common.construct_flame(cfg, train_ds, device=dev)
    model, params, state = common.construct_model(cfg, flame, device=dev)
    loss_fn = common.construct_loss(cfg, faces=model.faces, device=dev)
    optimizer = fateavatar_optimizers(config_to_dict(cfg.training))

    if main_rank:
        common.save_identity_info(cfg.workspace, train_ds, cfg)

    trainer = Trainer(
        name=cfg.name,
        model=model, params=params, state=state,
        loss_fn=loss_fn, optimizer=optimizer,
        train_dataset=train_ds, test_dataset=test_ds,
        workspace=cfg.workspace,
        maint_cfg=common.maintenance_config(cfg),
        render_cfg=common.render_config(cfg),
        tracking_lr=cfg.training.tracking_lr,
        seed=cfg.seed,
        data_parallel=args.dp,
        snapshot_interval=cfg.training.snapshot_interval,
        device_frame_cache=cfg.training.device_frame_cache,
        lpips_weights_path=cfg.assets.lpips_weights_path,
        scan_unroll=cfg.training.scan_unroll,
    )
    if args.resume:
        trainer.load_checkpoint()

    epochs = args.epochs or cfg.training.epochs.get(train_ds.type_name, 10)
    trainer.train(epochs)
    if train_ds.optimize_tracking:
        trainer.evaluate("test", optim_epoch=cfg.training.epochs.get("finetune", 50))
    else:
        trainer.evaluate("test")
    if mesh is not None:
        mesh.barrier()
        mesh.close()
    return trainer


if __name__ == "__main__":
    main()
