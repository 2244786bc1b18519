"""Dense-list tile blend: the CUDA kernels' wrappers, their plain PyTorch
versions, and :func:`tiles_to_image`.

Port of ``fateavatar_tpu/render/blend_tiles.py`` (forward and backward),
the blend of the ``kernel="tiles"`` route. Each tile walks its own dense
list of K = ``max_per_tile`` slots (``binning.build_tile_lists``), the
first ``min(counts[t], K)`` of them. The JAX package gathers the lists into
five ``[T, K, d]`` arrays; here they are one channel-major array
``data [9, T*K]`` (rows: mean_x, mean_y, conic_a, conic_b, conic_c,
color_r, color_g, color_b, opacity; tile t owns the columns
``[t*K, (t+1)*K)``) and a validity row ``valid [T*K]`` (1 where the slot
holds a gaussian), so the kernels walk the instance blend's layout.

:func:`blend_tiles` is differentiable (``_BlendTiles``, the counterpart of
the JAX package's ``custom_vjp``). On a CUDA tensor its forward launches
the hand-written kernel in ``csrc/blend_tiles.cu`` and its backward the one
in ``csrc/blend_tiles_bwd.cu`` (:func:`blend_tiles_bwd`); on a CPU tensor
both run their plain versions, :func:`blend_tiles_reference` and
:func:`blend_tiles_backward_reference`. Nothing falls back: a CUDA tensor
gets the kernel or an error.

Both kernels run the segmented walk of ``csrc/blend_common.cuh``, as the
instance kernels do: each tile's list is cut into segments of 256 slots,
counted from the tile's first slot, so that no block walks a long list
alone. Each wrapper call makes one host call that queues all of its
kernel's launches, with a scratch buffer (``blend_instances.scratch``) of
the size the C side asks for.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from fateavatar_tpu_torch.render import blend_instances as bi
from fateavatar_tpu_torch.render.binning import TILE
from fateavatar_tpu_torch.utils import cuda_build

P = TILE * TILE
NG = 9          # rows of the gathered lists and of their gradient

# the C entry points' signatures (csrc/blend_tiles*.cu)
_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_FWD_ARGS = (_PTR, _PTR, _I64, _PTR, _INT, _PTR, _PTR, _PTR, _INT, _INT, _PTR, _I64, _PTR)
_BWD_ARGS = (_PTR, _PTR, _I64, _PTR, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT,
             _PTR, _I64, _PTR)


def tiles_to_image(img_tiles: torch.Tensor, grid: Tuple[int, int],
                   width: int, height: int) -> torch.Tensor:
    """[T, 3, P] tile buffers -> [H, W, 3] image (crop padded edges)."""
    ty, tx = grid
    img = img_tiles.reshape(ty, tx, 3, TILE, TILE)
    img = img.permute(0, 3, 1, 4, 2).reshape(ty * TILE, tx * TILE, 3)
    return img[:height, :width]


def _check_inputs(data, valid, counts, bg, grid):
    """Shapes, types and devices of the blend's inputs; returns K."""
    T = grid[0] * grid[1]
    if (data.dtype != torch.float32 or data.dim() != 2 or data.shape[0] != NG
            or T == 0 or data.shape[1] % T):
        raise ValueError(f"data must be float32 [{NG}, T*K] with T = {T}, got "
                         f"{data.dtype} {tuple(data.shape)}")
    m = data.shape[1]
    if valid.dtype != torch.float32 or tuple(valid.shape) != (m,):
        raise ValueError(f"valid must be float32 [{m}], got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    if counts.dtype != torch.int32 or tuple(counts.shape) != (T,):
        raise ValueError(f"counts must be int32 [{T}], got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    if bg.dtype != torch.float32 or tuple(bg.shape) != (3,):
        raise ValueError(f"bg must be float32 [3], got {bg.dtype} {tuple(bg.shape)}")
    if not (data.device == valid.device == counts.device == bg.device):
        raise ValueError("data, valid, counts and bg must be on one device")
    return m // T


def _ranges(counts, k):
    """Tile t's occupied columns [s[t], e[t]): its first min(counts[t], K)
    slots, as the Pallas kernel bounds them (blend_tiles.py:213)."""
    s = torch.arange(counts.shape[0], device=counts.device) * k
    return s, s + counts.long().clamp(0, k)


def blend_tiles_reference(data, valid, counts, bg, grid, chunk=64):
    """Plain PyTorch version of the forward kernel: (img_tiles [T,3,P],
    t_final [T,P]). ``blend_tiles_xla``'s scan over ``chunk``-slot windows
    (blend_tiles.py:91-147) with the straight-through 0.99 clamp and the
    sticky ``q >= 1e-4`` termination, over each tile's first
    min(counts[t], K) slots. The CPU path, and the oracle the kernel is held
    against; differentiable by autograd, an independent check of the
    backward."""
    k = _check_inputs(data, valid, counts, bg, grid)
    img, t_final, _, _ = bi.blend_windows(data, valid, *_ranges(counts, k), bg,
                                          grid, chunk)
    return img, t_final


def pair_counts(data, valid, counts, grid):
    """(evaluated, blended) (slot, pixel) pairs of one blend on these
    inputs (see ``blend_instances.window_pair_counts``)."""
    k = _check_inputs(data, valid, counts,
                      torch.zeros(3, dtype=torch.float32, device=data.device), grid)
    return bi.window_pair_counts(data, valid, *_ranges(counts, k), grid)


def _check_backward_inputs(data, valid, counts, bg, img, t_final, g_img, g_tfin, grid):
    k = _check_inputs(data, valid, counts, bg, grid)
    T = grid[0] * grid[1]
    for name, x, shape in (("img", img, (T, 3, P)), ("t_final", t_final, (T, P)),
                           ("g_img", g_img, (T, 3, P)), ("g_tfin", g_tfin, (T, P))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be float32 {list(shape)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != data.device:
            raise ValueError(f"{name} must be on {data.device}")
    return k


def blend_tiles_backward_reference(data, valid, counts, bg, img, t_final, g_img,
                                   g_tfin, grid, chunk=64):
    """Plain PyTorch version of the backward kernel: g_data [9, T*K], the
    gradient of ``data`` given the forward's outputs and their cotangents
    (zero past each tile's first min(counts[t], K) slots). The math of
    ``_bwd_kernel`` (blend_tiles.py:261-370 of the JAX package) over the
    forward's windows. ``bg`` enters only through ``img``; its own gradient
    is ``einsum("tdp,tp->d", g_img, t_final)``."""
    k = _check_backward_inputs(data, valid, counts, bg, img, t_final, g_img,
                               g_tfin, grid)
    return bi.backward_windows(data, valid, *_ranges(counts, k), img, t_final,
                               g_img, g_tfin, grid, chunk, NG)


def _device_check(name, device, tensors):
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {device}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name} needs contiguous inputs")


def blend_tiles_bwd(data, valid, counts, bg, img, t_final, g_img, g_tfin, grid,
                    chunk=64, out=None):
    """Backward of the dense-list blend: g_data [9, T*K] (see
    :func:`blend_tiles_backward_reference`).

    A CUDA tensor launches the kernel (and counts the launch in
    ``blend_tiles_bwd.launches``), writing every element of ``out``
    (allocated when None); a CPU tensor runs the plain version, which walks
    ``chunk``-slot windows (the kernel has no such parameter)."""
    k = _check_backward_inputs(data, valid, counts, bg, img, t_final, g_img,
                               g_tfin, grid)
    if data.device.type == "cpu":
        return blend_tiles_backward_reference(data, valid, counts, bg, img, t_final,
                                              g_img, g_tfin, grid, chunk)
    _device_check("blend_tiles_bwd", data.device,
                  (data, valid, counts, img, t_final, g_img, g_tfin))
    m = data.shape[1]
    if out is None:
        out = torch.empty((NG, m), dtype=torch.float32, device=data.device)
    elif (out.dtype != torch.float32 or tuple(out.shape) != (NG, m)
          or out.device != data.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 [{NG}, {m}] tensor "
                         f"on {data.device}")
    ty, tx = grid
    buf = bi.scratch("blend_tiles_bwd", "blend_tiles_bwd", m, ty * tx, data.device)
    cuda_build.launch("blend_tiles_bwd", "blend_tiles_bwd", _BWD_ARGS, (
        data.data_ptr(), valid.data_ptr(), m, counts.data_ptr(), k, img.data_ptr(),
        t_final.data_ptr(), g_img.data_ptr(), g_tfin.data_ptr(), out.data_ptr(),
        ty * tx, tx, buf.data_ptr(), buf.numel()), data.device)
    blend_tiles_bwd.launches += 1
    return out


blend_tiles_bwd.launches = 0


def _blend_forward(data, valid, counts, bg, grid, chunk):
    """The forward on one device: the kernel on CUDA, the plain version on
    the CPU."""
    if data.device.type == "cpu":
        return blend_tiles_reference(data, valid, counts, bg, grid, chunk)
    _device_check("blend_tiles", data.device, (data, valid, counts, bg))
    ty, tx = grid
    T = ty * tx
    img = torch.empty((T, 3, P), dtype=torch.float32, device=data.device)
    t_final = torch.empty((T, P), dtype=torch.float32, device=data.device)
    m = data.shape[1]
    buf = bi.scratch("blend_tiles", "blend_tiles_fwd", m, T, data.device)
    cuda_build.launch("blend_tiles", "blend_tiles_fwd", _FWD_ARGS, (
        data.data_ptr(), valid.data_ptr(), m, counts.data_ptr(), m // T, bg.data_ptr(),
        img.data_ptr(), t_final.data_ptr(), T, tx, buf.data_ptr(), buf.numel()),
        data.device)
    blend_tiles.launches += 1
    return img, t_final


class _BlendTiles(torch.autograd.Function):
    """The blend with its backward (``_blend_fwd`` / ``_blend_bwd`` of the
    JAX package). ``plain`` runs both directions through the plain versions
    on any device (the comparisons of chip_smoke.py); otherwise the device
    picks kernel or plain version."""

    @staticmethod
    def forward(ctx, data, valid, counts, bg, grid, chunk, plain):
        if plain:
            img, t_final = blend_tiles_reference(data, valid, counts, bg, grid, chunk)
        else:
            img, t_final = _blend_forward(data, valid, counts, bg, grid, chunk)
        ctx.save_for_backward(data, valid, counts, bg, img, t_final)
        ctx.grid, ctx.chunk, ctx.plain = grid, chunk, plain
        return img, t_final

    @staticmethod
    def backward(ctx, g_img, g_tfin):
        data, valid, counts, bg, img, t_final = ctx.saved_tensors
        g_img, g_tfin = g_img.contiguous(), g_tfin.contiguous()
        bwd = blend_tiles_backward_reference if ctx.plain else blend_tiles_bwd
        g_data = bwd(data, valid, counts, bg, img, t_final, g_img, g_tfin, ctx.grid,
                     ctx.chunk)
        # outside the kernel, as in the JAX package (blend_tiles.py:484)
        g_bg = torch.einsum("tdp,tp->d", g_img, t_final)
        return g_data, None, None, g_bg, None, None, None


def blend_tiles(data, valid, counts, bg, grid, chunk=64):
    """Dense-list blend. data [9, T*K] and valid [T*K] float32 (see module
    docstring), counts [T] int32 (instances of each tile before the K cap),
    bg [3] float32, grid (tiles_y, tiles_x). Returns (img_tiles [T,3,P],
    t_final [T,P]), differentiable in ``data`` and ``bg``.

    A CUDA tensor launches the forward kernel (counted in
    ``blend_tiles.launches``) and, in the backward, the backward kernel
    (``blend_tiles_bwd.launches``); a CPU tensor runs the plain versions
    over ``chunk``-slot windows."""
    _check_inputs(data, valid, counts, bg, grid)
    return _BlendTiles.apply(data, valid, counts, bg, grid, chunk, False)


blend_tiles.launches = 0


def blend_tiles_plain(data, valid, counts, bg, grid, chunk=64):
    """:func:`blend_tiles` with both directions through the plain versions
    on any device: the yardstick the kernels are held against on the
    card."""
    _check_inputs(data, valid, counts, bg, grid)
    return _BlendTiles.apply(data, valid, counts, bg, grid, chunk, True)
