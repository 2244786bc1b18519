"""NeRSemble mono-FLAME-avatar benchmark CLI.

Port of ``fateavatar_tpu/cli/run_nersemble_benchmark.py``
(train_nersemble_benchmark_mono.py + run_nersemble_benchmark.py and the
looping .sh of the reference): per participant, train FateAvatar on the
train serial (intrinsics-shift cameras, the tracking's model-to-world head
pose), then render every test sequence x (the hold-out serials + the train
serial) to submission videos. FLAME takes ``n_shape`` and ``n_exp`` from
``flame_params.json`` (300 and 100 where it names neither). Runs on the card
unless ``--device cpu`` is given.

Usage:
  python -m fateavatar_tpu_torch.cli.run_nersemble_benchmark \\
      --config configs/fateavatar.yaml --root /data/nersemble_export \\
      --participants 393 404 461 477 486 --epochs 10
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--root", type=str, required=True,
                        help="exported benchmark layout (see benchmark/nersemble.py)")
    parser.add_argument("--participants", nargs="+", required=True)
    parser.add_argument("--train_serial", type=str, default=None)
    parser.add_argument("--train_sequences", nargs="*", default=None,
                        help="default: every sequence that has images")
    parser.add_argument("--test_sequences", nargs="*", default=None,
                        help="default: every sequence (the reference packs "
                        "SEQUENCES_TEST x hold-out+train serials)")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--crf", type=int, default=14)
    parser.add_argument("--out", type=str, default="./nersemble_submission")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train and render on (default cuda)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from fateavatar_tpu_torch.benchmark.nersemble import (
        DEFAULT_HOLD_OUT_SERIALS,
        DEFAULT_TRAIN_SERIAL,
        NersembleBenchmarkDataset,
        render_hold_out_serials,
        render_submission,
    )
    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.flame.loader import load_flame_pickle, make_flame
    from fateavatar_tpu_torch.train.optim import fateavatar_optimizers
    from fateavatar_tpu_torch.train.trainer import Trainer
    from fateavatar_tpu_torch.utils.config import config_to_dict, load_config
    from fateavatar_tpu_torch.utils.obj_io import load_obj

    cfg = load_config(args.config, args.overrides)
    dev = args.device
    train_serial = args.train_serial or DEFAULT_TRAIN_SERIAL
    trainers = []

    for participant in args.participants:
        seq_root = os.path.join(args.root, participant, "sequences")
        if args.train_sequences is not None:
            train_seqs = args.train_sequences
        elif os.path.isdir(seq_root):
            # train on every sequence that carries exported images
            train_seqs = sorted(s for s in os.listdir(seq_root)
                                if os.path.isdir(os.path.join(seq_root, s, "images")))
        else:
            train_seqs = None   # legacy single-sequence layout
        ds = NersembleBenchmarkDataset(args.root, participant, train_serial,
                                       cfg.dataset.img_res, sequence_list=train_seqs,
                                       mode="train")
        flame = make_flame(load_flame_pickle(cfg.assets.flame_model_path),
                           n_shape=ds.n_shape, n_exp=ds.n_exp,
                           shape_params=ds.shape_params,
                           canonical_expression=ds.mean_expression,
                           canonical_pose=cfg.dataset.canonical_pose, device=dev)
        model, params, state = common.construct_model(
            cfg, flame, template=load_obj(cfg.assets.template_mesh_path), device=dev)
        loss_fn = common.construct_loss(cfg, faces=model.faces, device=dev)
        optimizer = fateavatar_optimizers(config_to_dict(cfg.training))

        trainer = Trainer(
            name=f"nersemble_{participant}",
            model=model, params=params, state=state,
            loss_fn=loss_fn, optimizer=optimizer,
            train_dataset=ds, test_dataset=None,
            workspace=os.path.join(cfg.workspace, f"nersemble_{participant}"),
            maint_cfg=common.maintenance_config(cfg),
            render_cfg=common.render_config(cfg),
            seed=cfg.seed,
        )
        trainer.train(args.epochs)

        if args.test_sequences is not None:
            test_seqs = args.test_sequences
        elif os.path.isdir(seq_root):
            test_seqs = sorted(os.listdir(seq_root))
        else:
            test_seqs = []
        if test_seqs:
            # the reference pack loop: test sequences x (hold-outs + train
            # serial), CRF-14 mp4s (run_nersemble_benchmark.py:101-137)
            written = render_submission(
                model, trainer.ts.params, trainer.ts.state, args.root, participant,
                sequences=test_seqs, serials=[*DEFAULT_HOLD_OUT_SERIALS, train_serial],
                img_res=cfg.dataset.img_res, submit_dir=args.out,
                render_cfg=common.render_config(cfg), crf=args.crf)
        else:
            # legacy single-sequence layout: one video per hold-out serial
            written = render_hold_out_serials(
                model, trainer.ts.params, trainer.ts.state, args.root, participant,
                DEFAULT_HOLD_OUT_SERIALS, cfg.dataset.img_res,
                os.path.join(args.out, participant), common.render_config(cfg))
        print(f"[{participant}] wrote {len(written)} submission videos -> {args.out}")
        trainers.append(trainer)
    return trainers


if __name__ == "__main__":
    main()
