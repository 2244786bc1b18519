"""Stage-2a pseudo-view generation CLI (train_generate_pseudo.py:15-107).

Port of ``fateavatar_tpu/cli/train_generate_pseudo.py``: the pseudo-view
pipeline over a trained avatar. With ``--eg3d_weights`` (a ``G_ema``
state_dict as .pth or .npz) the EG3D PTI provider runs stages ⑤/⑥; without
it the weight-free mirror provider keeps the pipeline runnable. Runs on the
card unless ``--device cpu`` is given.

Usage:
  python -m fateavatar_tpu_torch.cli.train_generate_pseudo \\
      --config configs/fateavatar.yaml --workspace ./ws/obama \\
      --eg3d_weights g_ema.pth dataset.root_path=/data/insta/obama
"""

from __future__ import annotations

import argparse

# the plug-in networks and the official pickle wait for a later slice
_LATER = "not ported yet (ROADMAP Queue 1 item 9: the completion plug-ins)"


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--workspace", type=str, required=True)
    parser.add_argument("--num_views", type=int, default=30)
    parser.add_argument("--orbit_radius", type=float, default=None,
                        help="orbit camera distance; default = the subject's own "
                             "camera z distance (the reference orbits at "
                             "gs_camera_radius = camera_translation[-1], "
                             "completion.py:101)")
    parser.add_argument("--bisenet_weights", type=str, default=None,
                        help="face-parsing BiSeNet weights (not ported yet)")
    parser.add_argument("--eg3d_weights", type=str, default=None,
                        help="EG3D/PanoHead-family G_ema state_dict (.pth/.npz); "
                             "enables the PTI GAN-inversion provider for stage 5/6")
    parser.add_argument("--gfpgan_weights", type=str, default=None,
                        help="GFPGAN weights (not ported yet)")
    parser.add_argument("--modnet_weights", type=str, default=None,
                        help="MODNet matting weights (not ported yet)")
    parser.add_argument("--pti_w_steps", type=int, default=200)
    parser.add_argument("--pti_g_steps", type=int, default=200)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    for flag, what in (("modnet_weights", "MODNet matting (completion/matting.py)"),
                       ("bisenet_weights", "BiSeNet face parsing (completion/segmentation.py)"),
                       ("gfpgan_weights", "GFPGAN restoration (completion/restoration.py)")):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag}: {what} is {_LATER}")
    if args.eg3d_weights and args.eg3d_weights.endswith(".pkl"):
        raise NotImplementedError(
            f"--eg3d_weights {args.eg3d_weights}: the official pickle reader "
            f"(completion/eg3d/pkl_ingest.py) is {_LATER}; pass G_ema.state_dict() "
            "as a .pth or .npz")

    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.completion.pseudo import PseudoGenerator, PseudoGeneratorConfig
    from fateavatar_tpu_torch.train.loader import Loader
    from fateavatar_tpu_torch.utils.config import load_config

    cfg = load_config(args.config, args.overrides)
    cfg.workspace = args.workspace
    dev = args.device

    identity = common.load_identity_info(args.workspace)
    train_ds, _ = common.construct_datasets(cfg)
    flame = common.construct_flame(cfg, train_ds, device=dev)
    model, params0, state0 = common.construct_model(cfg, flame, device=dev)
    loader = Loader(model, params0, state0, args.workspace,
                    render_cfg=common.render_config(cfg))

    provider = None
    if args.eg3d_weights:
        from fateavatar_tpu_torch.completion.eg3d import PTIConfig, load_eg3d_from_torch
        from fateavatar_tpu_torch.completion.eg3d.provider import EG3DPseudoProvider
        from fateavatar_tpu_torch.train.losses import load_vgg16_from_torch

        generator, _ = load_eg3d_from_torch(args.eg3d_weights, device=dev)
        vgg = None
        if cfg.assets.vgg16_weights_path:
            vgg = load_vgg16_from_torch(cfg.assets.vgg16_weights_path, dev)
        provider = EG3DPseudoProvider(
            generator, PTIConfig(w_steps=args.pti_w_steps, pti_steps=args.pti_g_steps),
            vgg_params=vgg, log_fn=print)

    orbit_radius = args.orbit_radius
    if orbit_radius is None:
        # the reference's gs_camera_radius = camera_translation[-1]
        # (completion.py:101): orbit at the subject's capture distance so
        # the face size in the orbit renders matches the training footage
        orbit_radius = abs(float(identity["world_mat0"][2][3]))
    gen = PseudoGenerator(
        model, loader.params, loader.state,
        PseudoGeneratorConfig(
            num_views=args.num_views,
            orbit_radius=orbit_radius,
            out_dir=f"{args.workspace}/pseudo",
            # the reference rejects crops whose face is < 256 px at 512^2
            # renders (affine_util.py:99): scaled with the render resolution
            min_face_size=min(identity["img_res"]) // 2,
        ),
        render_cfg=common.render_config(cfg),
        provider=provider,
    )
    gen.result = gen.run(identity["fovx"], identity["fovy"])
    print(f"pseudo views written to {args.workspace}/pseudo")
    return gen


if __name__ == "__main__":
    main()
