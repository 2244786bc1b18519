"""Stage-2a pseudo-view generation CLI (train_generate_pseudo.py:15-107).

Port of ``fateavatar_tpu/cli/train_generate_pseudo.py``: the pseudo-view
pipeline over a trained avatar. With ``--eg3d_weights`` (a ``G_ema``
state_dict as .pth or .npz, or an official network pickle) the EG3D PTI
provider runs stages ⑤/⑥; without it the weight-free mirror provider keeps
the pipeline runnable. ``--gfpgan_weights`` restores the aligned crops
(stage ④); ``--modnet_weights`` mattes the pasted views (stage ⑧), else
``--bisenet_weights`` parses them into head masks, else the masks come from
the background colour. Every network runs on ``--device``: the card unless
``--device cpu`` is given.

Usage:
  python -m fateavatar_tpu_torch.cli.train_generate_pseudo \\
      --config configs/fateavatar.yaml --workspace ./ws/obama \\
      --eg3d_weights g_ema.pth dataset.root_path=/data/insta/obama
"""

from __future__ import annotations

import argparse


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
                        help="face-parsing.PyTorch 79999_iter.pth; enables BiSeNet "
                             "head masks for stage 8")
    parser.add_argument("--eg3d_weights", type=str, default=None,
                        help="EG3D/PanoHead-family G_ema state_dict (.pth/.npz) or "
                             "official network pickle (.pkl); enables the PTI "
                             "GAN-inversion provider for stage 5/6")
    parser.add_argument("--gfpgan_weights", type=str, default=None,
                        help="GFPGANv1.3/1.4 checkpoint; enables face restoration "
                             "for stage 4")
    parser.add_argument("--modnet_weights", type=str, default=None,
                        help="MODNet portrait-matting checkpoint; enables matting "
                             "for stage 8 (takes precedence over --bisenet_weights)")
    parser.add_argument("--pti_w_steps", type=int, default=200)
    parser.add_argument("--pti_g_steps", type=int, default=200)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

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

    matting_fn = None
    if args.modnet_weights:
        from fateavatar_tpu_torch.completion.matting import (
            MODNetMatting, load_modnet_from_torch,
        )

        matting_fn = MODNetMatting(load_modnet_from_torch(args.modnet_weights, dev))
    elif args.bisenet_weights:
        from fateavatar_tpu_torch.completion.segmentation import (
            load_bisenet_from_torch, make_bisenet_matting_fn,
        )

        matting_fn = make_bisenet_matting_fn(load_bisenet_from_torch(args.bisenet_weights, dev))

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

    restorer_fn = None
    if args.gfpgan_weights:
        from fateavatar_tpu_torch.completion.restoration import (
            GFPGANRestorer, load_gfpgan_from_torch,
        )

        restorer_fn = GFPGANRestorer(load_gfpgan_from_torch(args.gfpgan_weights,
                                                            device=dev)[0])

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
        matting_fn=matting_fn,
        restorer_fn=restorer_fn,
    )
    gen.result = gen.run(identity["fovx"], identity["fovy"])
    print(f"pseudo views written to {args.workspace}/pseudo")
    return gen


if __name__ == "__main__":
    main()
