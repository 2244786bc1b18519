"""Cross-identity reenactment CLI (avatar_reenact.py:18-94).

Port of ``fateavatar_tpu/cli/avatar_reenact.py``: drives a trained
destination avatar with a source subject's FLAME sequence, expression delta
= source canonical expression - destination mean expression
(avatar_reenact.py:85-88). Runs on the card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--dst_workspace", type=str, required=True)
    parser.add_argument("--src_root", type=str, required=True,
                        help="source subject dataset root (drives the avatar)")
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (default cuda)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.flame.loader import load_flame_pickle, make_flame
    from fateavatar_tpu_torch.ops.camera import make_camera
    from fateavatar_tpu_torch.train.datasets import construct_dataset
    from fateavatar_tpu_torch.train.loader import Reenactor
    from fateavatar_tpu_torch.utils.config import load_config

    cfg = load_config(args.config, args.overrides)
    dev = args.device

    identity = common.load_identity_info(args.dst_workspace)

    # destination avatar: rebuilt from identity info (no dataset needed)
    flame = make_flame(
        load_flame_pickle(cfg.assets.flame_model_path),
        n_shape=identity["n_shape"], n_exp=identity["n_exp"],
        shape_params=np.asarray(identity["shape_params"], np.float32),
        canonical_expression=np.asarray(identity["mean_expression"], np.float32),
        canonical_pose=identity["canonical_pose"],
        device=dev,
    )
    model, params, state = common.construct_model(cfg, flame, device=dev)

    reenactor = Reenactor(
        model, params, state, args.dst_workspace,
        render_cfg=common.render_config(cfg),
    )

    # source sequence
    src = construct_dataset(
        args.src_root, "test", identity["img_res"],
        use_mean_expression=True,
    )
    delta_exp = np.asarray(src.mean_expression[0]) - np.asarray(
        identity["mean_expression"]
    )[0, : src.mean_expression.shape[1]]

    wm = np.asarray(identity["world_mat0"], np.float32)
    h, w = identity["img_res"]
    camera = make_camera(
        wm[:3, :3].T, wm[:3, 3], identity["fovx"], identity["fovy"], w, h, device=dev
    )

    out = args.out or os.path.join(args.dst_workspace, "media", "reenact.mp4")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    frames = reenactor.reenact(
        src.expressions, src.flame_pose, delta_exp, camera, out_path=out
    )
    print(f"wrote {out}")
    return frames


if __name__ == "__main__":
    main()
