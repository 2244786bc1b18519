"""Construction helpers for the entry points (port of
``fateavatar_tpu/cli/common.py``): config -> datasets -> FLAME -> model, the
loss, the render and maintenance settings, and the identity-info artifact
used for dataset-free inference."""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from fateavatar_tpu_torch.flame.loader import (
    load_flame_pickle,
    load_landmark_embedding,
    make_flame,
)
from fateavatar_tpu_torch.models.fateavatar import FateAvatarConfig, init_fateavatar
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.train.datasets import FaceDataset, construct_dataset
from fateavatar_tpu_torch.train.losses import (
    FateAvatarLoss,
    FateAvatarLossConfig,
    load_vgg16_from_torch,
)
from fateavatar_tpu_torch.train.lpips import load_lpips_from_torch
from fateavatar_tpu_torch.train.step import MaintenanceConfig
from fateavatar_tpu_torch.utils.config import Config
from fateavatar_tpu_torch.utils.obj_io import ObjMesh, load_obj


def construct_datasets(cfg: Config) -> Tuple[FaceDataset, FaceDataset]:
    """The train and test sets under ``dataset.root_path`` (common.py:29-44),
    subsampled and cached as the config says."""
    ds_cfg = cfg.dataset
    kwargs = dict(
        img_res=ds_cfg.img_res,
        use_mean_expression=ds_cfg.use_mean_expression,
        use_var_expression=ds_cfg.use_var_expression,
        background_color=ds_cfg.background_color,
        cache_images=ds_cfg.cache_images,
    )
    train = construct_dataset(
        ds_cfg.root_path, "train", subsample=ds_cfg.train_subsample, **kwargs
    )
    test = construct_dataset(
        ds_cfg.root_path, "test", subsample=ds_cfg.test_subsample, **kwargs
    )
    return train, test


def construct_flame(cfg: Config, dataset=None, device="cuda"):
    """FLAME from the user-supplied pickle (common.py:62-75). With a
    dataset, its n_shape / n_exp, identity shape and mean expression are
    baked in; without one (inference from a workspace): n_shape 100, n_exp
    50, no identity shape, zero canonical expression. The landmark
    embedding comes from ``assets.landmark_embedding_path`` where it is set
    (the completion pipeline's keypoints need it)."""
    if dataset is not None:
        n_shape, n_exp = dataset.n_shape, dataset.n_exp
        shape_params, canonical_exp = dataset.shape_params, dataset.mean_expression
    else:
        n_shape, n_exp, shape_params, canonical_exp = 100, 50, None, None
    flame_data = load_flame_pickle(cfg.assets.flame_model_path)
    lmk_path = cfg.assets.landmark_embedding_path
    return make_flame(
        flame_data, n_shape=n_shape, n_exp=n_exp,
        shape_params=shape_params,
        canonical_expression=canonical_exp,
        canonical_pose=cfg.dataset.canonical_pose,
        landmark_embedding=load_landmark_embedding(lmk_path) if lmk_path else None,
        device=device,
    )


def construct_model(cfg: Config, flame, template: Optional[ObjMesh] = None,
                    device="cuda"):
    if template is None:
        template = load_obj(cfg.assets.template_mesh_path)
    bg = {"white": (1.0, 1.0, 1.0), "black": (0.0, 0.0, 0.0)}[
        cfg.dataset.background_color
    ]
    model_cfg = FateAvatarConfig(
        tex_size=cfg.model.tex_size,
        normal_offset=cfg.model.normal_offset,
        delta_blendshape=cfg.model.delta_blendshape,
        delta_vertex=cfg.model.delta_vertex,
        resize_scale=cfg.model.resize_scale,
        sh_degree=cfg.model.sh_degree,
        capacity=cfg.training.max_points_num,
        img_height=cfg.dataset.img_res[0],
        img_width=cfg.dataset.img_res[1],
    )
    return init_fateavatar(template, flame, model_cfg, bg_color=bg,
                           seed=cfg.seed, device=device)


def construct_loss(cfg: Config, faces=None, device="cuda") -> FateAvatarLoss:
    """The FateAvatar loss of the config (common.py:92-131). A VGG weight > 0
    needs ``assets.vgg16_weights_path`` and an LPIPS weight > 0
    ``assets.lpips_weights_path`` (loaded with the vgg backbone): without
    them this raises, as the JAX package does. ``faces`` (the model's) feed
    the normal-consistency term's adjacency."""
    vgg_params = None
    if cfg.loss.vgg_weight > 0:
        if cfg.assets.vgg16_weights_path is None:
            raise ValueError(
                "loss.vgg_weight > 0 needs assets.vgg16_weights_path "
                "(a torchvision vgg16 state_dict). Set loss.vgg_weight=0 "
                "to train without the perceptual term.")
        vgg_params = load_vgg16_from_torch(cfg.assets.vgg16_weights_path, device)
    lpips_params = None
    if cfg.loss.lpips_weight > 0:
        if cfg.assets.lpips_weights_path is None:
            raise ValueError(
                "loss.lpips_weight > 0 needs assets.lpips_weights_path "
                "(an exported lpips.LPIPS state_dict or converted .npz; "
                "the reference uses the vgg backbone for the loss term, "
                "train/loss.py:91). Set loss.lpips_weight=0 to disable.")
        lpips_params = load_lpips_from_torch(cfg.assets.lpips_weights_path,
                                             backbone="vgg", device=device)
    return FateAvatarLoss(loss_config(cfg), faces=faces, vgg_params=vgg_params,
                          lpips_params=lpips_params)


def loss_config(cfg: Config) -> FateAvatarLossConfig:
    return FateAvatarLossConfig(
        rgb_type=cfg.loss.rgb_type,
        rgb_weight=cfg.loss.rgb_weight,
        vgg_weight=cfg.loss.vgg_weight,
        vgg_dtype=(None if cfg.loss.vgg_dtype in (None, "float32")
                   else cfg.loss.vgg_dtype),
        dssim_weight=cfg.loss.dssim_weight,
        scale_weight=cfg.loss.scale_weight,
        scale_threshold=cfg.loss.scale_threshold,
        lpips_weight=cfg.loss.lpips_weight,
        rot_weight=cfg.loss.rot_weight,
        laplacian_weight=cfg.loss.laplacian_weight,
        normal_weight=cfg.loss.normal_weight,
        flame_weight=cfg.loss.flame_weight,
    )


def render_config(cfg: Config) -> RenderConfig:
    """The render settings of the config, as the JAX package's
    ``render_config`` reads them, ``autosize`` included (the Trainer reads
    it). ``max_per_tile`` and ``chunk`` are read by the ``kernel="tiles"``
    route, which a caller selects with ``dataclasses.replace`` (the yaml has
    no ``kernel`` key, as in the JAX package). ``render.impl`` is not read:
    in the port the tensors' device chooses between the CUDA kernels and
    their plain versions."""
    return RenderConfig(
        max_per_tile=cfg.render.max_per_tile,
        max_tiles_per_gaussian=cfg.render.max_tiles_per_gaussian,
        chunk=cfg.render.chunk,
        instance_budget=cfg.render.instance_budget,
        t_cutoff=cfg.render.t_cutoff,
        binning=cfg.render.binning,
        autosize=cfg.render.autosize,
    )


def maintenance_config(cfg: Config) -> MaintenanceConfig:
    t = cfg.training
    return MaintenanceConfig(
        densify_interval=t.densify_interval,
        prune_interval=t.prune_interval,
        opacity_reset_interval=t.opacity_reset_interval,
        increase_num=t.increase_num,
        min_opacity=t.min_opacity,
        max_points_num=t.max_points_num,
    )


def save_identity_info(workspace: str, dataset, cfg: Config) -> dict:
    """Persist the identity metadata needed to rebuild a model without the
    dataset (common.py:121-173: shape params, canonical expression, fov, a
    camera)."""
    info = {
        "shape_params": np.asarray(dataset.shape_params).tolist(),
        "mean_expression": np.asarray(dataset.mean_expression).tolist(),
        "n_shape": dataset.n_shape,
        "n_exp": dataset.n_exp,
        "fovx": float(dataset.fovx),
        "fovy": float(dataset.fovy),
        "canonical_pose": cfg.dataset.canonical_pose,
        "img_res": cfg.dataset.img_res,
        "world_mat0": np.asarray(dataset.world_mats[0]).tolist(),
        "dataset_type": dataset.type_name,
    }
    os.makedirs(workspace, exist_ok=True)
    with open(os.path.join(workspace, "identity_info.json"), "w") as f:
        json.dump(info, f, indent=2)
    return info


def load_identity_info(workspace: str) -> dict:
    with open(os.path.join(workspace, "identity_info.json")) as f:
        return json.load(f)
