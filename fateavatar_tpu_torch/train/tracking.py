"""Per-frame FLAME-tracking refinement (IMAvatar datasets).

Port of ``fateavatar_tpu/train/tracking.py``: the reference's sparse
nn.Embedding tables + torch.optim.SparseAdam (train/base.py:113-151) as
plain tensors and a ROW-WISE Adam: each frame's row keeps its own step count
and moments, and an update touches only the rows visited. Updates are
functional: they return new tables and a new state.

The tracking steps take the gradient of a frame's full loss with respect to
its rows only (``torch.autograd.grad`` with the rows as inputs): the model's
parameters and state are read, never written, and gather no gradient. With
tracing on, a refinement marks its stages as a pass of its own
(``utils/profiling.py``): ``forward`` and ``backward`` here (the loss of the
frame marks ``loss``), ``optimizer`` and ``end`` in the row update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from fateavatar_tpu_torch.utils import profiling

FIELDS = ("expression", "flame_pose", "cam_t")


@dataclass
class TrackingTables:
    """Per-frame learnable FLAME/camera corrections."""

    expression: torch.Tensor   # [F, n_exp]
    flame_pose: torch.Tensor   # [F, 15]
    cam_t: torch.Tensor        # [F, 3] camera translation override


@dataclass
class RowAdamState:
    mu: TrackingTables
    nu: TrackingTables
    count: torch.Tensor        # [F] int32 per-row step count


def _map(fn, *tables: TrackingTables) -> TrackingTables:
    return TrackingTables(**{f: fn(*(getattr(t, f) for t in tables)) for f in FIELDS})


@dataclass(frozen=True)
class RowAdam:
    lr: float = 5e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, tables: TrackingTables) -> RowAdamState:
        return RowAdamState(
            mu=_map(torch.zeros_like, tables),
            nu=_map(torch.zeros_like, tables),
            count=torch.zeros((tables.expression.shape[0],), dtype=torch.int32,
                              device=tables.expression.device),
        )

    def update_row(
        self,
        tables: TrackingTables,
        opt_state: RowAdamState,
        row_grads: TrackingTables,   # gradients for ONE row (no leading dim)
        idx,                         # the frame index: an int, or a one-element
                                     # int tensor on the tables' device
    ) -> Tuple[TrackingTables, RowAdamState]:
        """SparseAdam step on a single row. A device index keeps the step free
        of host values, so it can be captured in a CUDA graph."""
        dev = opt_state.count.device
        profiling.mark("optimizer", dev)
        if not torch.is_tensor(idx):
            idx = torch.tensor(idx)
        idx1 = idx.to(dev).reshape(1).long()
        count = opt_state.count[idx1] + 1                     # [1]
        cf = count.to(torch.float32)
        c1 = 1.0 - self.b1 ** cf
        c2 = 1.0 - self.b2 ** cf

        new_t, new_mu, new_nu = {}, {}, {}
        for f in FIELDS:
            table, mu, nu = getattr(tables, f), getattr(opt_state.mu, f), getattr(opt_state.nu, f)
            g = getattr(row_grads, f)[None]
            m_row = self.b1 * mu[idx1] + (1 - self.b1) * g
            v_row = self.b2 * nu[idx1] + (1 - self.b2) * g * g
            step = -self.lr * (m_row / c1) / (torch.sqrt(v_row / c2) + self.eps)
            new_t[f] = table.index_add(0, idx1, step)
            new_mu[f] = mu.index_copy(0, idx1, m_row)
            new_nu[f] = nu.index_copy(0, idx1, v_row)
        profiling.mark("end", dev)
        return (
            TrackingTables(**new_t),
            RowAdamState(mu=TrackingTables(**new_mu), nu=TrackingTables(**new_nu),
                         count=opt_state.count.index_copy(0, idx1, count)),
        )

    def update_rows(
        self,
        tables: TrackingTables,
        opt_state: RowAdamState,
        row_grads: TrackingTables,   # gradients for B rows (leading dim B)
        idxs: torch.Tensor,          # [B] frame indices
        mask: torch.Tensor,          # [B] bool; False rows are no-ops
    ) -> Tuple[TrackingTables, RowAdamState]:
        """SparseAdam step on B rows at once. ``mask`` disables rows (a
        padded batch's duplicates): they are dropped from every scatter, so
        a masked duplicate of a live index cannot race its row's write."""
        profiling.mark("optimizer", opt_state.count.device)
        n_rows = tables.expression.shape[0]
        idxs = idxs.long()
        count = opt_state.count[idxs] + mask.to(torch.int32)   # [B]
        cf = count.to(torch.float32)
        c1 = 1.0 - self.b1 ** cf
        c2 = 1.0 - self.b2 ** cf
        # masked rows scatter into a scratch row past the table, cut off after
        live_idx = torch.where(mask, idxs, n_rows)

        def scatter(table, rows, add):
            padded = torch.cat([table, table.new_zeros((1,) + table.shape[1:])])
            out = (padded.index_add(0, live_idx, rows) if add
                   else padded.index_copy(0, live_idx, rows))
            return out[:n_rows]

        new_t, new_mu, new_nu = {}, {}, {}
        for f in FIELDS:
            table, mu, nu = getattr(tables, f), getattr(opt_state.mu, f), getattr(opt_state.nu, f)
            g = getattr(row_grads, f)
            mb = mask.reshape((-1,) + (1,) * (g.dim() - 1))
            m_old, v_old = mu[idxs], nu[idxs]
            m_row = torch.where(mb, self.b1 * m_old + (1 - self.b1) * g, m_old)
            v_row = torch.where(mb, self.b2 * v_old + (1 - self.b2) * g * g, v_old)
            step = torch.where(
                mb, -self.lr * (m_row / c1[:, None]) / (torch.sqrt(v_row / c2[:, None]) + self.eps),
                0.0)
            new_t[f] = scatter(table, step, add=True)
            new_mu[f] = scatter(mu, m_row, add=False)
            new_nu[f] = scatter(nu, v_row, add=False)
        padded = torch.cat([opt_state.count, opt_state.count.new_zeros(1)])
        profiling.mark("end", opt_state.count.device)
        return (
            TrackingTables(**new_t),
            RowAdamState(mu=TrackingTables(**new_mu), nu=TrackingTables(**new_nu),
                         count=padded.index_copy(0, live_idx, count)[:n_rows]),
        )


def tracking_tensors(tables: TrackingTables, state: RowAdamState) -> list:
    """Every tensor of ``tables`` and of their RowAdam ``state``, in a fixed
    order."""
    return [*(getattr(t, f) for t in (tables, state.mu, state.nu) for f in FIELDS),
            state.count]


def clone_tracking(tables: TrackingTables, state: RowAdamState):
    """Copies of ``tables`` and ``state`` (the static buffers of a CUDA
    graph)."""
    return (_map(torch.clone, tables),
            RowAdamState(mu=_map(torch.clone, state.mu), nu=_map(torch.clone, state.nu),
                         count=state.count.clone()))


def tables_from_dataset(dataset, device="cuda") -> TrackingTables:
    """Initialize the tables from dataset FLAME params (train/base.py:117-137)."""
    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device).clone()

    return TrackingTables(expression=t(dataset.expressions),
                          flame_pose=t(dataset.flame_pose),
                          cam_t=t(dataset.world_mats[:, :3, 3]))


def row_gradients(loss_of_frame: Callable, expression, flame_pose, cam_t,
                  *consts) -> TrackingTables:
    """d loss_of_frame(expression, flame_pose, cam_t, *consts) / d rows, for
    one frame's rows; nothing else receives a gradient."""
    profiling.mark("forward", expression.device)
    rows = [x.detach().requires_grad_() for x in (expression, flame_pose, cam_t)]
    with torch.enable_grad():
        loss = loss_of_frame(*rows, *consts)
        profiling.mark("backward", expression.device)
        ge, gp, gt = torch.autograd.grad(loss, rows)
    return TrackingTables(expression=ge, flame_pose=gp, cam_t=gt)


def make_batched_tracking_step(loss_of_frame: Callable, optimizer: RowAdam,
                               gather: Optional[Callable] = None):
    """Tracking refinement of B frames' rows in one update (the companion of
    :func:`make_tracking_step` for ``Trainer.optimize_tracking`` and the
    data-parallel epoch).

    ``loss_of_frame(expression, flame_pose, cam_t, frame_const, shared)``:
    ``frame_consts`` is a sequence of B per-frame constants, ``shared`` holds
    the model params/state. The B gradients are taken one frame after the
    other, then one :meth:`RowAdam.update_rows` applies them. With
    ``gather`` (a data-parallel rank): ``idxs``, ``mask`` and the constants
    are this rank's frames', ``gather(x)`` concatenates a tensor over the
    ranks in rank order, and every rank applies the same update to all the
    ranks' rows."""

    def step(tables: TrackingTables, opt_state: RowAdamState,
             idxs: torch.Tensor, mask: torch.Tensor, frame_consts, shared):
        grads = [row_gradients(loss_of_frame, tables.expression[i], tables.flame_pose[i],
                               tables.cam_t[i], const, shared)
                 for i, const in zip(idxs, frame_consts)]
        row_grads = _map(lambda *g: torch.stack(g), *grads)
        if gather is not None:
            idxs, mask, row_grads = gather(idxs), gather(mask), _map(gather, row_grads)
        return optimizer.update_rows(tables, opt_state, row_grads, idxs, mask)

    return step


def make_tracking_step(loss_of_frame: Callable, optimizer: RowAdam):
    """A step optimizing ONE frame's tracking row.

    ``loss_of_frame(expression, flame_pose, cam_t, frame_const) -> scalar``
    reads the model params (frozen during tracking, matching
    train/base.py:198-235 where only the embeddings receive gradients)."""

    def step(tables: TrackingTables, opt_state: RowAdamState, idx, frame_const):
        g = row_gradients(loss_of_frame, tables.expression[idx], tables.flame_pose[idx],
                          tables.cam_t[idx], frame_const)
        return optimizer.update_row(tables, opt_state, g, idx)

    return step
