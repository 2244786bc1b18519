"""Family adapters: any registered avatar family through the Trainer.

Port of ``fateavatar_tpu/train/adapters.py``. The reference drives all five
model families through ONE trainer (train/trainer.py:79-101 keeps per-model
hook dicts for step, visualize and checkpoint); here that role is a small
adapter record built from a ``train/registry.py`` entry, so the ``Trainer``
gives every family its epochs, prefetch, meters, tracking, evaluation
media, checkpoints and snapshots.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional


@dataclass
class FamilyAdapter:
    """What the Trainer needs from a model family.

    step:       (train_state, Frame, maintain=True) -> (train_state, aux
                dict); aux holds "loss", "psnr" and "overflow" as device
                scalars. With maintain=False it reads no host step count
                and runs no host-gated branch: the form the Trainer captures
                as a CUDA graph for its scan epoch.
                ``step.due(n)`` says whether the step that brings the count
                to ``n`` runs a host-gated branch (densify, opacity reset,
                walk); the scan epoch runs those steps eagerly. ``due`` is
                None where the step has no maintain=False form (GaussianAvatars
                with an lr schedule), and its epochs then run per step.
    init_ts:    (seed) -> train state.
    forward:    (params, state, expr, pose, camera, bg) -> model output dict
                with at least "rgb_image" (evaluation, fps, tracking,
                snapshots).
    visualize:  optional (params, state, expr, pose, camera) -> dict with
                rgb_image / cano_image / grad_image / point_image / verts
                (FateAvatar's multi-panel snapshot); None -> pred / gt / heat.
    epoch_hook: optional (trainer, epoch) -> None, run after each epoch
                (MonoGaussianAvatar's prune / upsample schedule). It may
                replace ``trainer.ts`` with tensors of the same shapes (the
                next scan epoch copies them into its graph's buffers).
    """

    name: str
    step: Callable
    init_ts: Callable[[int], Any]
    forward: Callable
    visualize: Optional[Callable] = None
    epoch_hook: Optional[Callable] = None


def make_family_adapter(name: str, bundle, loss_fn, optimizer, render_cfg,
                        training_cfg: dict) -> FamilyAdapter:
    """The adapter of a registry family from its build functions' outputs;
    ``bundle`` is what ``registry.get(name).build_model`` returned."""
    from fateavatar_tpu_torch.train import baseline_steps as BS
    from fateavatar_tpu_torch.train import registry

    if name == "fateavatar":
        raise ValueError("fateavatar uses the Trainer's built-in default adapter")
    entry = registry.get(name)
    step = entry.build_step(bundle, loss_fn, optimizer, render_cfg, training_cfg)
    model, params0 = bundle[0], bundle[1]
    state0 = bundle[2] if len(bundle) > 2 and not callable(bundle[2]) else None

    def init_ts(seed: int = 0):
        return BS._init_ts(params0, state0, optimizer, seed=seed)

    if name == "gaussianavatars":
        from fateavatar_tpu_torch.models.baselines import gaussianavatars as GA

        def forward(params, state, expr, pose, camera, bg):
            return GA.ga_forward(model, params, state, expr, pose, camera, bg_color=bg,
                                 render_cfg=render_cfg)
    elif name == "flashavatar":
        from fateavatar_tpu_torch.models.baselines import flashavatar as FA

        net = bundle[2]

        def forward(params, state, expr, pose, camera, bg):
            return FA.flash_forward(model, params, net, expr, pose, camera, bg_color=bg,
                                    render_cfg=render_cfg)
    elif name == "splattingavatar":
        from fateavatar_tpu_torch.models.baselines import splattingavatar as SA

        def forward(params, state, expr, pose, camera, bg):
            return SA.splat_forward(model, params, state, expr, pose, camera, bg_color=bg,
                                    render_cfg=render_cfg)
    elif name == "monogaussianavatar":
        from fateavatar_tpu_torch.models.baselines import monogaussianavatar as MA

        nets = bundle[3]

        def forward(params, state, expr, pose, camera, bg):
            return MA.mono_forward(model, params, state, nets, expr, pose, camera,
                                   bg_color=bg, render_cfg=render_cfg)
    else:
        raise KeyError(f"no adapter for family {name!r}")

    epoch_hook = None
    if name == "monogaussianavatar":
        def epoch_hook(trainer, epoch):
            mesh = trainer.dp_mesh
            trainer.ts = BS.mono_epoch_maintenance(
                trainer.ts, model, epoch, share=None if mesh is None else mesh.broadcast)

    return FamilyAdapter(name=name, step=step, init_ts=init_ts, forward=forward,
                         epoch_hook=epoch_hook)
