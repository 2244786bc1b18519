"""Typed configuration system (a copy of ``fateavatar_tpu/utils/config.py``:
the port reads the same YAML files, so it keeps every section and key; the
keys the port does not use yet are read and ignored). One addition: a
``key.path=value`` override may name one entry of a mapping, as in
``training.epochs.finetune=3``.

The reference uses YAML -> EasyDict with ad-hoc CLI overrides and no schema
(tools/util.py:12-39, common.py:25-31). Here configs are typed dataclasses
with YAML loading and dotted-path overrides (``training.scaling_lr=0.01``),
so a typo fails loudly instead of silently training with defaults.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class DatasetSection:
    root_path: str = ""
    use_mean_expression: bool = True
    use_var_expression: bool = True
    canonical_pose: float = 0.2
    background_color: str = "white"
    img_res: List[int] = field(default_factory=lambda: [512, 512])
    train_subsample: int = 1
    test_subsample: int = 1
    cache_images: bool = True


@dataclass
class LossSection:
    rgb_type: str = "l1"
    vgg_dtype: str = "bfloat16"   # float32 | bfloat16
    scale_threshold: float = 9.0
    rgb_weight: float = 1.0
    vgg_weight: float = 0.0
    dssim_weight: float = 0.0
    scale_weight: float = 0.1
    lpips_weight: float = 0.0
    rot_weight: float = 0.0
    laplacian_weight: float = 100000.0
    normal_weight: float = 0.0
    flame_weight: float = 0.0
    # gaussianavatars regularizer knobs (train/loss.py:327-381 in the ref)
    xyz_weight: float = 0.01
    threshold_scale: float = 0.6
    threshold_xyz: float = 1.0


@dataclass
class ModelSection:
    name: str = "fateavatar"
    tex_size: int = 256
    normal_offset: float = 0.05
    delta_blendshape: bool = True
    delta_vertex: bool = True
    resize_scale: bool = True
    sh_degree: int = 0
    # baseline-family knobs (ignored by families that don't use them)
    num_samples: int = 10000       # splattingavatar: canonical surface samples
    n_init_points: int = 400       # monogaussianavatar: initial point count
    max_points: int = 100000       # monogaussianavatar: upsample ceiling
    cam_scale: float = 3.0         # monogaussianavatar: camera scale factor


@dataclass
class TrainingSection:
    feature_dc_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    offset_lr: float = 0.0016
    delta_shapedirs_lr: float = 1e-5
    delta_posedirs_lr: float = 1e-5
    delta_vertex_lr: float = 1e-4
    tracking_lr: float = 5e-4
    opacity_reset_interval: int = 60000
    densify_interval: int = 3000
    prune_interval: int = 2000
    min_opacity: float = 0.005
    increase_num: int = 1000
    max_points_num: int = 200000
    snapshot_interval: int = 1000          # media snapshot cadence
    device_frame_cache: str = "auto"       # on | off | auto (device-resident uint8 gt)
    scan_unroll: int = 3                   # the JAX trainer's scan-epoch unroll
    # baseline-family knobs
    densify_grad_threshold: float = 1e-4   # gaussianavatars clone/split gate
    densify_from_iter: int = 10000         # gaussianavatars densify warmup
    active_sh_degree: int = 0              # gaussianavatars starting SH degree
    triangle_walk_interval: int = 100      # splattingavatar UVD walk commit
    epochs: Dict[str, int] = field(
        default_factory=lambda: {"imavatar": 50, "insta": 10, "finetune": 50}
    )


@dataclass
class RenderSection:
    impl: str = "auto"
    max_per_tile: int = 1024
    max_tiles_per_gaussian: int = 64
    chunk: int = 64
    # static instance-array budget (0 = auto 4N); trained 512^2 avatars fit
    # 2N (bench.py) — overflow is counted and logged, never silent
    instance_budget: int = 0
    # measure the dataset's tile occupancy at startup and size
    # instance_budget / max_tiles_per_gaussian / tail_k from it
    # (render/autosize.py) instead of the static values above
    autosize: bool = False
    # instance binning flavour (render/render.py RenderConfig.binning)
    binning: str = "onesort"
    # > 0 enables the chunk-granular T < cutoff early exit (renderCUDA's
    # per-pixel 1e-4 semantics, forward.cu:343-351). Default 0 keeps the
    # exact closed form — A/B'd faster on dense synthetic workloads, the
    # cutoff pays off on saturated trained avatars
    t_cutoff: float = 0.0


@dataclass
class AssetsSection:
    """External weights the user supplies (zero are bundled):
    FLAME pickle, head template OBJ, optional VGG16 torch weights."""
    flame_model_path: str = "./weights/generic_model.pkl"
    template_mesh_path: str = "./weights/head_template_mouth_close.obj"
    landmark_embedding_path: Optional[str] = None  # landmark_embedding.npy
    vgg16_weights_path: Optional[str] = None
    lpips_weights_path: Optional[str] = None


@dataclass
class Config:
    name: str = "fateavatar"
    workspace: str = "./workspace"
    seed: int = 42
    dataset: DatasetSection = field(default_factory=DatasetSection)
    loss: LossSection = field(default_factory=LossSection)
    model: ModelSection = field(default_factory=ModelSection)
    training: TrainingSection = field(default_factory=TrainingSection)
    render: RenderSection = field(default_factory=RenderSection)
    assets: AssetsSection = field(default_factory=AssetsSection)


def _update_dataclass(obj, data: dict, path=""):
    for key, val in data.items():
        if not hasattr(obj, key):
            raise KeyError(f"unknown config key: {path}{key}")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            _update_dataclass(cur, val, path=f"{path}{key}.")
        else:
            setattr(obj, key, val)


def load_config(path: Optional[str] = None, overrides: Optional[list] = None) -> Config:
    """YAML file + ``key.path=value`` CLI overrides -> validated Config."""
    import yaml

    cfg = Config()
    if path is not None:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        _update_dataclass(cfg, data)
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, raw = ov.split("=", 1)
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = obj[p] if isinstance(obj, dict) else getattr(obj, p)
        val: Any = yaml.safe_load(raw)
        if isinstance(obj, dict):     # one entry of a mapping (training.epochs)
            obj[parts[-1]] = val
        else:
            getattr(obj, parts[-1])   # an unknown key raises
            setattr(obj, parts[-1], val)
    return cfg


def config_to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)
