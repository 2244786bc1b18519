"""Row gathers (port of ``fateavatar_tpu/ops/gathers.py::gather_rows``).

``index_select``: its transpose is an ``index_add_``. Where many rows of a
static capacity are dead and all point at row 0, their (zero) gradients
would pile onto that one row; :func:`gather_live_rows` spreads them.
"""

from __future__ import annotations

import torch


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` ([F, D] x [N] -> [N, D])."""
    return table.index_select(0, idx)


def gather_live_rows(table: torch.Tensor, idx: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for the ``alive`` rows; a dead row i reads row
    ``i mod F`` instead. Dead rows render nothing, so what they read is
    unused and their gradients are zero; spread over the table, those zeros
    do not pile onto one row in the transpose's atomic adds (a capacity of
    200,000 with 190,000 dead rows all bound to face 0, in the baselines)."""
    spread = torch.arange(idx.shape[0], device=idx.device) % table.shape[0]
    return table.index_select(0, torch.where(alive, idx, spread))
