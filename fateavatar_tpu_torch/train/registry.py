"""Model registry: name -> the functions that build model, loss, optimizer and step.

Port of ``fateavatar_tpu/train/registry.py`` (train/callbacks.py:20-40 of
the reference): the one place that makes all five avatar families
constructible by name behind one trainer. A model is built on the device
of the FLAME model it is given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

MODEL_REGISTRY: Dict[str, "ModelEntry"] = {}


@dataclass
class ModelEntry:
    name: str
    build_model: Callable      # (template, flame, cfg_dict) -> bundle
    build_loss: Callable       # (cfg_dict, bundle) -> loss_fn
    build_optimizer: Callable  # (training_cfg_dict) -> MultiAdam
    build_step: Callable       # (bundle, loss_fn, opt, render_cfg, cfg) -> step


def register(entry: ModelEntry):
    MODEL_REGISTRY[entry.name] = entry
    return entry


def get(name: str) -> ModelEntry:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; registered: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def _register_builtin():
    from fateavatar_tpu_torch.models.baselines import flashavatar as FA
    from fateavatar_tpu_torch.models.baselines import gaussianavatars as GA
    from fateavatar_tpu_torch.models.baselines import monogaussianavatar as MA
    from fateavatar_tpu_torch.models.baselines import splattingavatar as SA
    from fateavatar_tpu_torch.models.fateavatar import FateAvatarConfig, init_fateavatar
    from fateavatar_tpu_torch.train import baseline_steps as BS
    from fateavatar_tpu_torch.train import losses as L
    from fateavatar_tpu_torch.train.optim import fateavatar_optimizers
    from fateavatar_tpu_torch.train.step import MaintenanceConfig, make_train_step

    def bg(cfg):
        return cfg.get("bg_color", (1.0, 1.0, 1.0))

    register(ModelEntry(
        name="fateavatar",
        build_model=lambda template, flame, cfg: init_fateavatar(
            template, flame,
            FateAvatarConfig(
                tex_size=cfg.get("tex_size", 256),
                normal_offset=cfg.get("normal_offset", 0.05),
                delta_blendshape=cfg.get("delta_blendshape", True),
                delta_vertex=cfg.get("delta_vertex", True),
                resize_scale=cfg.get("resize_scale", True),
                sh_degree=cfg.get("sh_degree", 0),
                capacity=cfg.get("capacity", 200_000),
                img_height=cfg.get("img_height", 512),
                img_width=cfg.get("img_width", 512),
            ),
            bg_color=bg(cfg), device=flame.v_template.device,
        ),
        build_loss=lambda cfg, bundle: L.FateAvatarLoss(
            L.FateAvatarLossConfig(**{k: v for k, v in cfg.items()
                                      if k in L.FateAvatarLossConfig.__dataclass_fields__}),
            vgg_params=cfg.get("vgg_params"),
        ),
        build_optimizer=fateavatar_optimizers,
        build_step=lambda bundle, loss_fn, opt, render_cfg, cfg: make_train_step(
            bundle[0], loss_fn, opt,
            MaintenanceConfig(
                densify_interval=cfg.get("densify_interval", 3000),
                prune_interval=cfg.get("prune_interval", 2000),
                opacity_reset_interval=cfg.get("opacity_reset_interval", 60000),
                increase_num=cfg.get("increase_num", 1000),
                min_opacity=cfg.get("min_opacity", 0.005),
                max_points_num=cfg.get("max_points_num", 200_000),
            ),
            render_cfg,
        ),
    ))

    register(ModelEntry(
        name="gaussianavatars",
        build_model=lambda template, flame, cfg: GA.init_gaussianavatars(
            flame,
            GA.GAConfig(
                sh_degree=cfg.get("sh_degree", 3),
                capacity=cfg.get("capacity", 200_000),
                img_height=cfg.get("img_height", 512),
                img_width=cfg.get("img_width", 512),
            ),
            bg_color=bg(cfg),
        ),
        build_loss=lambda cfg, bundle: L.GaussianAvatarsLoss(
            L.GaussianAvatarsLossConfig(
                rgb_weight=cfg.get("rgb_weight", 0.8),
                dssim_weight=cfg.get("dssim_weight", 0.2),
                scale_weight=cfg.get("scale_weight", 1.0),
                xyz_weight=cfg.get("xyz_weight", 0.01),
                threshold_scale=cfg.get("threshold_scale", 0.6),
                threshold_xyz=cfg.get("threshold_xyz", 1.0),
            )
        ),
        build_optimizer=BS.gaussianavatars_optimizer,
        build_step=lambda bundle, loss_fn, opt, render_cfg, cfg:
            BS.make_gaussianavatars_step(
                bundle[0], loss_fn, opt, render_cfg,
                active_sh_degree=cfg.get("active_sh_degree", 0),
                densify_interval=cfg.get("densify_interval", 2000),
                densify_from=cfg.get("densify_from_iter", 10000),
                densify_grad_threshold=cfg.get("densify_grad_threshold", 1e-4),
                min_opacity=cfg.get("min_opacity", 0.005),
                opacity_reset_interval=cfg.get("opacity_reset_interval", 60000),
            ),
    ))

    register(ModelEntry(
        name="flashavatar",
        build_model=lambda template, flame, cfg: FA.init_flashavatar(
            template, flame,
            FA.FlashConfig(
                tex_size=cfg.get("tex_size", 128),
                img_height=cfg.get("img_height", 512),
                img_width=cfg.get("img_width", 512),
            ),
            bg_color=bg(cfg),
        ),
        build_loss=lambda cfg, bundle: L.FlashAvatarLoss(),
        build_optimizer=BS.flashavatar_optimizer,
        build_step=lambda bundle, loss_fn, opt, render_cfg, cfg:
            BS.make_flashavatar_step(bundle[0], bundle[2], loss_fn, opt, render_cfg),
    ))

    register(ModelEntry(
        name="splattingavatar",
        build_model=lambda template, flame, cfg: SA.init_splattingavatar(
            flame,
            SA.SplatConfig(
                num_samples=cfg.get("num_samples", 10000),
                capacity=cfg.get("capacity", 60000),
                img_height=cfg.get("img_height", 512),
                img_width=cfg.get("img_width", 512),
            ),
            bg_color=bg(cfg),
        ),
        build_loss=lambda cfg, bundle: L.SplattingAvatarLoss(),
        build_optimizer=BS.splattingavatar_optimizer,
        build_step=lambda bundle, loss_fn, opt, render_cfg, cfg:
            BS.make_splattingavatar_step(
                bundle[0], loss_fn, opt, render_cfg,
                triangle_walk_interval=cfg.get("triangle_walk_interval", 100),
            ),
    ))

    register(ModelEntry(
        name="monogaussianavatar",
        build_model=lambda template, flame, cfg: MA.init_monogaussianavatar(
            flame,
            MA.MonoConfig(
                n_init_points=cfg.get("n_init_points", 400),
                max_points=cfg.get("max_points", 100_000),
                img_height=cfg.get("img_height", 512),
                img_width=cfg.get("img_width", 512),
                cam_scale=cfg.get("cam_scale", 3.0),
            ),
            bg_color=bg(cfg),
        ),
        # the config's dataset type only, as the JAX package builds it: the
        # yaml's vgg_weight does not reach this loss (ROADMAP Queue 3)
        build_loss=lambda cfg, bundle: L.MonoGaussianAvatarLoss(
            L.MonoGaussianAvatarLossConfig(dataset_type=cfg.get("dataset_type", "insta")),
            bundle[0].flame,
        ),
        build_optimizer=BS.monogaussianavatar_optimizer,
        build_step=lambda bundle, loss_fn, opt, render_cfg, cfg:
            BS.make_monogaussianavatar_step(bundle[0], bundle[3], loss_fn, opt, render_cfg),
    ))


_register_builtin()
