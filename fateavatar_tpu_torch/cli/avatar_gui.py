"""Interactive viewer CLI (avatar_gui.py:18-89).

Port of ``fateavatar_tpu/cli/avatar_gui.py``: resolve the newest checkpoint
variant (``checkpoints_baked/baked.npz``, else the latest training
checkpoint with its tracking tables) and serve the web viewer
(``viewer/web.py``), whose frame is a CUDA graph on the card unless
``--device cpu`` is given.

Usage:
  python -m fateavatar_tpu_torch.cli.avatar_gui --config configs/fateavatar.yaml \\
      --workspace ./ws/obama --port 8090 dataset.root_path=/data/insta/obama
"""

from __future__ import annotations

import argparse
import os


def build_viewer(argv=None):
    """Parse ``argv``, load the avatar and build the
    :class:`~fateavatar_tpu_torch.viewer.web.ViewerServer` (not yet
    serving; ``port`` 0 takes a free one). The server's ``variant`` says
    what was loaded ("baked" or "latest")."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--workspace", type=str, required=True)
    parser.add_argument("--port", type=int, default=8090)
    parser.add_argument("--variant", type=str, default="auto",
                        choices=["auto", "latest", "baked"])
    parser.add_argument("--camera_distance", type=float, default=1.0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (default cuda)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.train.loader import Loader
    from fateavatar_tpu_torch.utils.config import load_config
    from fateavatar_tpu_torch.viewer.web import ViewerServer, make_avatar_render_fn

    cfg = load_config(args.config, args.overrides)
    cfg.workspace = args.workspace
    dev = args.device

    train_ds, test_ds = common.construct_datasets(cfg)
    flame = common.construct_flame(cfg, train_ds, device=dev)
    model, params0, state0 = common.construct_model(cfg, flame, device=dev)

    # checkpoint-variant resolution (avatar_gui.py:51-68): prefer baked,
    # then the latest training checkpoint
    baked = os.path.join(args.workspace, "checkpoints_baked", "baked.npz")
    tables = None
    if args.variant in ("auto", "baked") and os.path.exists(baked):
        from fateavatar_tpu_torch.train.checkpoints import load_pytree

        tree = load_pytree(baked, {"params": params0, "state": state0})
        params, state = tree["params"], tree["state"]
        variant = "baked"
        print("loaded baked avatar")
    else:
        loader = Loader(model, params0, state0, args.workspace,
                        render_cfg=common.render_config(cfg))
        params, state = loader.params, loader.state
        tables = loader.tables   # tracking-refined per-frame params, if any
        variant = "latest"
        print(f"loaded training checkpoint (epoch {loader.epoch})"
              + (" + tracking tables" if tables is not None else ""))

    # playback drives TRAIN-sequence frames (the reference GUI's train-mode
    # playback of tracking-refined params, tools/gui.py:606-637)
    render_fn = make_avatar_render_fn(
        model, params, state, dataset=train_ds if tables is not None else test_ds,
        camera_distance=args.camera_distance,
        render_cfg=common.render_config(cfg),
        tables=tables,
    )
    server = ViewerServer(render_fn, model.cfg.img_width, model.cfg.img_height,
                          model.flame.n_exp, port=args.port)
    server.variant = variant
    return server


def main(argv=None):
    build_viewer(argv).serve_forever()


if __name__ == "__main__":
    main()
