from fateavatar_tpu_torch.completion.eg3d.networks import (
    EG3DConfig, EG3DGenerator, eg3d_random_params, mapping_network, synthesis, render_full,
)
from fateavatar_tpu_torch.completion.eg3d.pti import (
    PTIConfig, compute_w_stats, project_w, pti_finetune,
)
from fateavatar_tpu_torch.completion.eg3d.convert import load_eg3d_from_torch

__all__ = [
    "EG3DConfig", "EG3DGenerator", "eg3d_random_params", "mapping_network", "synthesis",
    "render_full", "PTIConfig", "compute_w_stats", "project_w", "pti_finetune",
    "load_eg3d_from_torch",
]
