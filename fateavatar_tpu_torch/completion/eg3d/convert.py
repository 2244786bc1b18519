"""Checkpoint loading for the EG3D-family generator.

Port of ``fateavatar_tpu/completion/eg3d/convert.py``. The exchange format
is the plain ``state_dict`` of ``G_ema`` (``torch.save(G_ema.state_dict(),
'g_ema.pth')`` in the original repository) or an ``.npz`` of the same
mapping, such as the JAX package's param dict saved with ``np.savez``. Names
are kept verbatim, and the layouts match (conv [O,I,kh,kw], fc [out,in]),
so loading is :meth:`EG3DGenerator.load_state_dict` after a shape audit
against :class:`EG3DConfig`. An official network pickle (``.pkl``) is read
by ``pkl_ingest.load_eg3d_from_pkl`` without executing its embedded code.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from fateavatar_tpu_torch.completion.eg3d.networks import EG3DConfig, EG3DGenerator

_PREFIXES = ("backbone.mapping.", "backbone.synthesis.", "decoder.", "superresolution.")


def infer_config(raw: Dict[str, np.ndarray]) -> EG3DConfig:
    """An :class:`EG3DConfig` derived from the checkpoint's tensor shapes."""
    w_dim = raw["backbone.mapping.fc0.weight"].shape[0]
    n_map = len([k for k in raw
                 if k.startswith("backbone.mapping.fc") and k.endswith(".weight")])
    z_dim = raw["backbone.mapping.fc0.weight"].shape[1]
    c_dim = 0
    if "backbone.mapping.embed.weight" in raw:
        c_dim = raw["backbone.mapping.embed.weight"].shape[1]
        z_dim -= raw["backbone.mapping.embed.weight"].shape[0]
    res = max(int(k.split(".b")[1].split(".")[0]) for k in raw
              if k.startswith("backbone.synthesis.b") and ".conv1.weight" in k)
    img_ch = raw[f"backbone.synthesis.b{res}.torgb.weight"].shape[0]
    dec_in = raw["decoder.net.0.weight"].shape[1]
    dec_out = raw["decoder.net.2.weight"].shape[0] - 1
    depth = img_ch // (3 * dec_in)
    hidden = raw["decoder.net.0.weight"].shape[0]
    sr_blocks = len([k for k in raw
                     if k.startswith("superresolution.block") and k.endswith(".torgb.weight")])
    ch_max = raw["backbone.synthesis.b4.const"].shape[0]
    # channel_base from the highest-resolution block's output channels
    ch_top = raw[f"backbone.synthesis.b{res}.conv1.weight"].shape[0]
    # the SR blocks upsample from the neural-rendering resolution (EG3D: 128)
    neural = 128 if res >= 128 else res // 2
    return EG3DConfig(
        z_dim=z_dim, c_dim=c_dim, w_dim=w_dim, num_mapping_layers=n_map,
        backbone_resolution=res, plane_channels=dec_in, triplane_depth=depth,
        channel_base=ch_top * res, channel_max=ch_max, decoder_hidden=hidden,
        decoder_out=dec_out,
        sr_resolution=neural * (2 ** sr_blocks),
        sr_channels=(raw["superresolution.block0.conv0.weight"].shape[0]
                     if sr_blocks else 128),
        neural_resolution=neural,
    )


def generator_from_dict(raw: Dict[str, np.ndarray], cfg: Optional[EG3DConfig] = None,
                        device="cuda") -> EG3DGenerator:
    """An :class:`EG3DGenerator` holding ``raw`` (name -> array; the JAX
    package's param dict as numpy arrays, or a state_dict), through
    ``load_state_dict``. Tensors the generator does not use are ignored; a
    missing one raises, naming it."""
    raw = {k: v for k, v in raw.items() if k.startswith(_PREFIXES)}
    if cfg is None:
        cfg = infer_config(raw)
    gen = EG3DGenerator(cfg, device=device)
    own = gen.state_dict()
    missing = sorted(set(own) - set(raw))
    if missing:
        raise KeyError(f"EG3D checkpoint lacks {len(missing)} tensors of {cfg}: "
                       f"{missing[:5]}")
    gen.load_state_dict({k: torch.from_numpy(np.array(raw[k], np.float32)) for k in own})
    return gen


def load_eg3d_from_torch(path: str, cfg: Optional[EG3DConfig] = None, device="cuda"):
    """Load a G_ema state_dict (.pth / .pt through ``torch.load`` with
    ``weights_only=True``, or .npz), or the ``G_ema`` of an official network
    pickle (.pkl). Returns (generator, config); the config is inferred from
    the shapes unless given."""
    if path.endswith(".pkl"):
        from fateavatar_tpu_torch.completion.eg3d.pkl_ingest import load_eg3d_from_pkl

        gen, cfg, _ = load_eg3d_from_pkl(path, cfg=cfg, device=device)
        return gen, cfg
    if path.endswith(".npz"):
        with np.load(path) as d:
            raw = {k: np.asarray(d[k]) for k in d.files}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        raw = {k: v.detach().cpu().numpy() for k, v in sd.items() if hasattr(v, "detach")}
    raw = {k: v for k, v in raw.items() if k.startswith(_PREFIXES)}
    if not raw:
        raise ValueError(f"{path}: no EG3D generator tensors found "
                         f"(expected keys starting with {_PREFIXES})")
    gen = generator_from_dict(raw, cfg, device)
    return gen, gen.cfg
