"""Instance-range tile blend: the CUDA kernels' wrappers and their plain
PyTorch versions.

Port of ``fateavatar_tpu/render/blend_instances.py`` (forward and
backward). The blend
walks the FLAT depth-sorted instance array with per-tile [start, end)
ranges — the data layout of ``renderCUDA`` (rasterizer_impl.cu point_list +
ranges). Instance data lives channel-major as [16, M]:

  0 mean_x, 1 mean_y, 2 conic_a, 3 conic_b, 4 conic_c,
  5 color_r, 6 color_g, 7 color_b, 8 opacity, 9 valid, 10..15 zero pad.

:func:`blend_instances` is differentiable (``_BlendInstances``, the
counterpart of the JAX package's ``custom_vjp``). On a CUDA tensor its
forward launches the hand-written kernel in ``csrc/blend_instances.cu`` and
its backward the one in ``csrc/blend_instances_bwd.cu``
(:func:`blend_instances_bwd`); on a CPU tensor both run their plain
versions, :func:`blend_instances_reference` and
:func:`blend_instances_backward_reference`. Nothing falls back: a CUDA
tensor gets the kernel or an error.

Both kernels run the segmented walk of ``csrc/blend_common.cuh``: each
tile's range is cut into segments of 256 columns, one block each, joined
through each segment's transmittance product, so that no block walks a long
tile alone. Each wrapper call makes one host call that queues all of its
kernel's launches, with a scratch buffer (:func:`scratch`) allocated here
at the size the C side asks for.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fateavatar_tpu_torch.render.binning import TILE
from fateavatar_tpu_torch.utils import cuda_build

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1.0e-4  # renderCUDA's termination threshold (forward.cu:347)
P = TILE * TILE
ROW = 16
CHUNK = 128     # instances per window of the plain version

# the C entry points' signatures (csrc/blend_instances*.cu)
_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_FLT = ctypes.c_float
_FWD_ARGS = (_PTR, _I64, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _PTR, _I64, _FLT, _PTR, _PTR,
             _I64, _PTR)
_BWD_ARGS = (_PTR, _I64, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _PTR, _I64, _PTR,
             _PTR)
_CUT_ARGS = (_PTR, _I64, _PTR, _INT, _INT, _FLT, _PTR, _PTR, _I64, _PTR)


@functools.lru_cache(maxsize=64)
def _scratch_floats(lib, entry, m, n_tiles):
    return cuda_build.call(lib, f"{entry}_scratch_floats", (_I64, _INT), (m, n_tiles),
                           ctypes.c_int64)


def scratch(lib, entry, m, n_tiles, device):
    """The scratch of C entry point ``entry`` of ``csrc/<lib>.cu``: one
    ``torch.empty`` of the floats its ``<entry>_scratch_floats`` asks for
    (the layout lives in the C source alone; the entry point refuses a
    shorter buffer). The caller may drop it when the launch returns:
    PyTorch's caching allocator hands the memory only to work queued after
    the kernels on the same stream."""
    return torch.empty(_scratch_floats(lib, entry, m, n_tiles), dtype=torch.float32,
                       device=device)


def _check_inputs(inst_data, tile_starts, bg, grid):
    ty, tx = grid
    if inst_data.dtype != torch.float32 or inst_data.dim() != 2 or inst_data.shape[0] != ROW:
        raise ValueError(f"inst_data must be float32 [{ROW}, M], got "
                         f"{inst_data.dtype} {tuple(inst_data.shape)}")
    if tile_starts.dtype != torch.int32 or tuple(tile_starts.shape) != (ty * tx + 1,):
        raise ValueError(f"tile_starts must be int32 [{ty * tx + 1}], got "
                         f"{tile_starts.dtype} {tuple(tile_starts.shape)}")
    if bg.dtype != torch.float32 or tuple(bg.shape) != (3,):
        raise ValueError(f"bg must be float32 [3], got {bg.dtype} {tuple(bg.shape)}")
    if not (inst_data.device == tile_starts.device == bg.device):
        raise ValueError("inst_data, tile_starts and bg must be on one device")


def _tile_pixel_coords(grid, device):
    """Integer pixel coordinates (no +0.5) of every tile: (T, P) x / y."""
    ty, tx = grid
    lin = torch.arange(P, dtype=torch.float32, device=device)
    tix = torch.arange(tx, dtype=torch.float32, device=device) * TILE
    tiy = torch.arange(ty, dtype=torch.float32, device=device) * TILE
    px = (tix[None, :, None] + (lin % TILE)[None, None, :]).expand(ty, tx, P)
    py = (tiy[:, None, None] + (lin // TILE)[None, None, :]).expand(ty, tx, P)
    return px.reshape(-1, P), py.reshape(-1, P)


def _clamp_straight_through(raw):
    """min(raw, 0.99) whose gradient passes straight through the clamp, as
    renderCUDA's backward does (backward.cu:499,538,554). The value is
    exactly 0.99 where clamped, so forward results are unchanged."""
    return torch.where(raw > ALPHA_MAX, ALPHA_MAX + (raw - raw.detach()), raw)


def _window(rows, valid, s, e, i, chunk):
    """Window ``i`` of every tile's column range [s[t], e[t]): its columns'
    channels 0-8 as [9, T, W, 1] and (valid and in range) as [T, W, 1]."""
    m = rows.shape[1]
    pos = s[:, None] + i * chunk + torch.arange(chunk, device=rows.device)  # [T, W]
    in_range = pos < e[:, None]
    col = pos.clamp(0, m - 1)
    ok = (valid[col] > 0) & in_range
    return pos, in_range, rows[:9, col][..., None], ok[..., None]


def window_cut(rows, valid, s, e, grid, cutoff, window=CHUNK, return_margin=False):
    """The plain version of the early exit's cut (the Pallas kernels'
    ``cutoff`` > 0, blend_instances.py:157-170 of the JAX package): tile t
    walks its range [s[t], e[t]) in ``window``-column windows counted from
    absolute multiples of ``window``, window 0 always, each later one only
    while some pixel's q >= ``cutoff`` (q the product of (1 - alpha) over
    every instance of the range so far that passes the skip test,
    termination ignored). Returns cut [T] int64: the end of the last window
    run, clipped to e. The blend of [s, cut) is the early exit's result.
    With ``return_margin`` also each tile's smallest |max q - cutoff| /
    cutoff over the decisions it took (inf for a tile that took none): how
    far another rounding of q would have to move to change its cut."""
    ty, tx = grid
    dev = rows.device
    m = rows.shape[1]
    px, py = _tile_pixel_coords(grid, dev)
    px, py = px[:, None, :], py[:, None, :]                   # [T, 1, P]
    w0 = torch.div(s, window, rounding_mode="floor") * window
    nwin = torch.div(e - w0 + window - 1, window, rounding_mode="floor")
    q = torch.ones((ty * tx, P), dtype=rows.dtype, device=dev)
    ran = torch.zeros_like(s)
    going = nwin > 0
    margin = torch.full((ty * tx,), float("inf"), dtype=torch.float64, device=dev)
    lane = torch.arange(window, device=dev)
    i = 0
    while True:
        going = going & (i < nwin)
        if i > 0:
            top = q.amax(dim=1)
            margin = torch.where(going, torch.minimum(
                margin, (top.double() - cutoff).abs() / cutoff), margin)
            going = going & (top >= cutoff)
        act = torch.nonzero(going).squeeze(1)           # the tiles that run window i
        if act.numel() == 0:
            break
        pos = w0[act, None] + i * window + lane                   # [A, W]
        ok = (pos >= s[act, None]) & (pos < e[act, None])
        col = pos.clamp(0, m - 1)
        data = rows[:9, col][..., None]                           # [9, A, W, 1]
        ok = (ok & (valid[col] > 0))[..., None]
        dx = data[0] - px[act]
        dy = data[1] - py[act]
        power = -0.5 * (data[2] * dx * dx + data[4] * dy * dy) - data[3] * dx * dy
        alpha = torch.clamp_max(data[8] * torch.exp(torch.clamp_max(power, 0.0)), ALPHA_MAX)
        alpha = torch.where((power <= 0.0) & (alpha >= ALPHA_MIN) & ok, alpha, 0.0)
        q = q.index_put((act,), q[act] * torch.cumprod(1.0 - alpha, dim=1)[:, -1])
        ran = ran + going.to(ran.dtype)
        i += 1
    cut = torch.minimum(e, w0 + window * ran)
    return (cut, margin) if return_margin else cut


def blend_windows(rows, valid, s, e, bg, grid, chunk):
    """The plain blend: tile t walks the columns [s[t], e[t]) of ``rows``
    ([>= 9, M]: mean xy, conic abc, rgb, opacity) in ``chunk``-column
    windows (all tiles at once), carrying transmittance and colour between
    windows, as ``blend_tiles_xla``'s scan does (blend_tiles.py:112-142). A
    column blends only where ``valid`` [M] > 0. Peak memory is a few
    [T, chunk, P] tensors. Sums run in ``rows``' dtype. Returns (img [T,3,P], t_final [T,P],
    evaluated [T,P], blended [T,P]): ``evaluated`` counts the instances each
    pixel reaches before it terminates, the pairs a sequential per-pixel
    loop computes; ``blended`` those of them it blends. The early exit
    passes each range ending at its :func:`window_cut`."""
    ty, tx = grid
    T = ty * tx
    dev = rows.device
    px, py = _tile_pixel_coords(grid, dev)
    px, py = px[:, None, :], py[:, None, :]                   # [T, 1, P]
    t_carry = torch.ones((T, P), dtype=rows.dtype, device=dev)
    q_carry = torch.ones((T, P), dtype=rows.dtype, device=dev)
    acc = torch.zeros((T, 3, P), dtype=rows.dtype, device=dev)
    evaluated = torch.zeros((T, P), dtype=torch.int64, device=dev)
    blended = torch.zeros((T, P), dtype=torch.int64, device=dev)
    longest = int((e - s).max()) if T else 0
    for i in range((longest + chunk - 1) // chunk):
        # only the tiles whose range reaches window i: it is a no-op for
        # the others
        act = torch.nonzero(e - s > i * chunk).squeeze(1)
        _, in_range, data, ok = _window(rows, valid, s[act], e[act], i, chunk)
        in_range = in_range[..., None]                        # [A, W, 1]
        t_a, q_a = t_carry[act], q_carry[act]
        dx = data[0] - px[act]
        dy = data[1] - py[act]
        power = -0.5 * (data[2] * dx * dx + data[4] * dy * dy) - data[3] * dx * dy
        raw = data[8] * torch.exp(torch.clamp_max(power, 0.0))
        alpha = _clamp_straight_through(raw)
        keep = (power <= 0.0) & (alpha >= ALPHA_MIN) & ok
        alpha = torch.where(keep, alpha, 0.0)
        # CUDA termination (forward.cu:346-351): q, the transmittance with
        # every alpha applied, is monotone; an instance counts while q
        # stays >= T_EPS, the crossing one is dropped and T freezes
        q_incl = q_a[:, None, :] * torch.cumprod(1.0 - alpha, dim=1)
        q_excl = torch.cat([q_a[:, None, :], q_incl[:, :-1]], dim=1)
        evaluated = evaluated.index_add(0, act, ((q_excl >= T_EPS) & in_range).sum(dim=1))
        alpha = torch.where(q_incl >= T_EPS, alpha, 0.0)
        blended = blended.index_add(0, act, (alpha > 0).sum(dim=1))
        t_incl = torch.cumprod(1.0 - alpha, dim=1)
        t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
        w = alpha * t_excl * t_a[:, None, :]                  # [A, W, P]
        acc = acc.index_add(0, act, torch.einsum("twp,dtw->tdp", w, data[5:8, :, :, 0]))
        t_carry = t_carry.index_put((act,), t_a * t_incl[:, -1])
        q_carry = q_carry.index_put((act,), q_incl[:, -1])
    img = acc + t_carry[:, None, :] * bg[None, :, None]
    return img, t_carry, evaluated, blended


def _plain_forward(inst_data, tile_starts, bg, grid, cutoff):
    """The plain forward, (img, t_final, cut): with ``cutoff`` > 1e-4 each
    range ends at its :func:`window_cut` (``cut``, int32 [T]), else the
    exact blend (``cut`` None)."""
    s, e = _ranges(tile_starts)
    cut = None
    if cutoff > T_EPS:
        cut = window_cut(inst_data, inst_data[9], s, e, grid, cutoff).to(torch.int32)
        e = cut.long()
    img, t_final, _, _ = blend_windows(inst_data, inst_data[9], s, e, bg, grid, CHUNK)
    return img, t_final, cut


def blend_instances_reference(inst_data, tile_starts, bg, grid, cutoff=0.0):
    """Plain PyTorch version of the forward kernel: (img_tiles [T,3,P],
    t_final [T,P]), with the early exit of ``cutoff`` > 1e-4. The CPU path,
    and the oracle the kernel is held against. Differentiable by autograd
    (with the straight-through clamp): an independent check of the
    backward."""
    _check_inputs(inst_data, tile_starts, bg, grid)
    return _plain_forward(inst_data, tile_starts, bg, grid, cutoff)[:2]


def _ranges(tile_starts, cut=None):
    """Each tile's (start, end) as int64, the end at ``cut`` when given."""
    s, e = tile_starts[:-1].long(), tile_starts[1:].long()
    return (s, e) if cut is None else (s, torch.minimum(e, cut.long()))


def blend_cut(inst_data, tile_starts, grid, cutoff):
    """The early exit's cut column of each tile, int32 [T]
    (:func:`window_cut`): on a CUDA tensor the cut's launches that kernel 1
    queues first (``blend_instances_cut`` of csrc/blend_instances.cu: each
    128-column window's products, then each tile's scan; not counted as a
    launch of kernel 1), on a CPU tensor the plain version."""
    _check_inputs(inst_data, tile_starts,
                  torch.zeros(3, dtype=torch.float32, device=inst_data.device), grid)
    if inst_data.device.type == "cpu":
        return window_cut(inst_data, inst_data[9], *_ranges(tile_starts), grid,
                          cutoff).to(torch.int32)
    ty, tx = grid
    m = inst_data.shape[1]
    cut = torch.empty((ty * tx,), dtype=torch.int32, device=inst_data.device)
    buf = scratch("blend_instances", "blend_instances_cut", m, ty * tx, inst_data.device)
    cuda_build.launch("blend_instances", "blend_instances_cut", _CUT_ARGS, (
        inst_data.data_ptr(), m, tile_starts.data_ptr(), ty * tx, tx, cutoff, cut.data_ptr(),
        buf.data_ptr(), buf.numel()), inst_data.device)
    return cut


def window_pair_counts(rows, valid, s, e, grid, chunk=CHUNK):
    """(evaluated, blended): the (instance, pixel) pairs a sequential
    front-to-back loop with T<1e-4 termination evaluates when tile t walks
    the columns [s[t], e[t]), and those of them it blends (alpha >= 1/255,
    before termination) — the data-dependent work of one blend, for its
    bound."""
    bg = torch.zeros(3, dtype=torch.float32, device=rows.device)
    with torch.no_grad():
        _, _, evaluated, blended = blend_windows(rows, valid, s, e, bg, grid, chunk)
    return int(evaluated.sum()), int(blended.sum())


def pair_counts(inst_data, tile_starts, grid):
    """:func:`window_pair_counts` of the instance blend's inputs."""
    _check_inputs(inst_data, tile_starts,
                  torch.zeros(3, dtype=torch.float32, device=inst_data.device), grid)
    return window_pair_counts(inst_data, inst_data[9], *_ranges(tile_starts), grid)


def _check_backward_inputs(inst_data, tile_starts, bg, img, t_final, g_img,
                           g_tfin, grid):
    _check_inputs(inst_data, tile_starts, bg, grid)
    T = grid[0] * grid[1]
    for name, x, shape in (("img", img, (T, 3, P)), ("t_final", t_final, (T, P)),
                           ("g_img", g_img, (T, 3, P)), ("g_tfin", g_tfin, (T, P))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be float32 {list(shape)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != inst_data.device:
            raise ValueError(f"{name} must be on {inst_data.device}")


def blend_instances_backward_reference(inst_data, tile_starts, bg, img, t_final,
                                       g_img, g_tfin, grid, cut=None):
    """Plain PyTorch version of the backward kernel: g_inst [16, M], the
    gradient of rows 0-8 of ``inst_data`` (rows 9-15 and every column outside
    the tiles' ranges are zero), given the forward's outputs and their
    cotangents. The math of ``_bwd_kernel`` (blend_instances.py:183-316 of
    the JAX package): the window loop of :func:`blend_windows`, all tiles at
    once, with the same cumulative products, so it agrees with the plain
    forward on which instances are kept and where each pixel terminates.
    ``bg`` enters only through ``img``; its own gradient is
    ``einsum("tdp,tp->d", g_img, t_final)``. Under the early exit, ``cut``
    is the forward's cut (int32 [T]): each range ends there, and the columns
    past it get 0."""
    _check_backward_inputs(inst_data, tile_starts, bg, img, t_final, g_img,
                           g_tfin, grid)
    return backward_windows(inst_data, inst_data[9], *_ranges(tile_starts, cut), img,
                            t_final, g_img, g_tfin, grid, CHUNK, ROW)


def backward_windows(rows, valid, s, e, img, t_final, g_img, g_tfin, grid,
                     chunk, n_out):
    """The plain backward of :func:`blend_windows`' blend: the gradient of
    channels 0-8 of ``rows`` as [n_out, M] (rows 9 and up, and every column
    outside the tiles' ranges, zero). Walks the same ``chunk``-column
    windows with the same cumulative products as the forward, so it agrees
    with it on which instances are kept and where each pixel terminates.
    Sums run in ``rows``' dtype. The early exit passes the forward's
    shortened ranges; the columns past them get 0."""
    ty, tx = grid
    T = ty * tx
    dev = rows.device
    m = rows.shape[1]
    px, py = _tile_pixel_coords(grid, dev)
    px, py = px[:, None, :], py[:, None, :]                   # [T, 1, P]
    gdotimg = (g_img[:, 0] * img[:, 0] + g_img[:, 1] * img[:, 1]
               + g_img[:, 2] * img[:, 2])[:, None, :]          # [T, 1, P]
    gt_tn = (g_tfin * t_final)[:, None, :]
    g = g_img[:, :, None, :]                                   # [T, 3, 1, P]
    t_carry = torch.ones((T, P), dtype=rows.dtype, device=dev)
    q_carry = torch.ones((T, P), dtype=rows.dtype, device=dev)
    pu_carry = torch.zeros((T, P), dtype=rows.dtype, device=dev)
    # one extra column takes the writes of slots outside every range
    g_out = torch.zeros((n_out, m + 1), dtype=rows.dtype, device=dev)
    longest = int((e - s).max()) if T else 0
    for i in range((longest + chunk - 1) // chunk):
        # only the tiles whose range reaches window i
        act = torch.nonzero(e - s > i * chunk).squeeze(1)
        pos, in_range, data, ok = _window(rows, valid, s[act], e[act], i, chunk)
        t_a, q_a, pu_a, g_a = t_carry[act], q_carry[act], pu_carry[act], g[act]
        dx = data[0] - px[act]
        dy = data[1] - py[act]
        ca, cb, cc = data[2], data[3], data[4]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        exp_power = torch.exp(torch.clamp_max(power, 0.0))
        raw = data[8] * exp_power
        alpha = torch.clamp_max(raw, ALPHA_MAX)
        keep = (power <= 0.0) & (alpha >= ALPHA_MIN) & ok
        alpha = torch.where(keep, alpha, 0.0)
        # the forward's termination: the crossing instance and every later
        # one are dropped (backward.cu:486-488)
        q_incl = q_a[:, None, :] * torch.cumprod(1.0 - alpha, dim=1)
        alive = q_incl >= T_EPS
        keep = keep & alive
        alpha = torch.where(alive, alpha, 0.0)
        om = 1.0 - alpha
        t_incl = torch.cumprod(om, dim=1)
        t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
        t_j = t_excl * t_a[:, None, :]                        # [A, W, P]
        w = alpha * t_j
        gdotc = (g_a[:, 0] * data[5] + g_a[:, 1] * data[6]) + g_a[:, 2] * data[7]
        pu = pu_a[:, None, :] + torch.cumsum(w * gdotc, dim=1)
        inv_om = 1.0 / om
        dalpha = (t_j * gdotc - (gdotimg[act] - pu) * inv_om - gt_tn[act] * inv_om)
        dalpha = torch.where(keep, dalpha, 0.0)
        # straight through the 0.99 clamp: the unclamped raw = op * G
        g_power = dalpha * raw
        partials = torch.stack([
            g_power * (-ca * dx - cb * dy),
            g_power * (-cc * dy - cb * dx),
            g_power * (-0.5 * dx * dx),
            g_power * (-dx * dy),
            g_power * (-0.5 * dy * dy),
            w * g_a[:, 0],
            w * g_a[:, 1],
            w * g_a[:, 2],
            dalpha * exp_power,
        ]).sum(dim=-1)                                        # [9, A, W]
        col = torch.where(in_range, pos, m).reshape(-1)
        g_out[:9].index_put_((torch.arange(9, device=dev)[:, None], col[None, :]),
                             partials.reshape(9, -1))
        t_carry[act] = t_a * t_incl[:, -1]
        q_carry[act] = q_incl[:, -1]
        pu_carry[act] = pu[:, -1]
    return g_out[:, :m].contiguous()


def blend_instances_bwd(inst_data, tile_starts, bg, img, t_final, g_img, g_tfin,
                        grid, out=None, cut=None):
    """Backward of the instance blend: g_inst [16, M] (see
    :func:`blend_instances_backward_reference`). ``cut``: the forward's cut
    columns (int32 [T]) under the early exit, else None.

    A CUDA tensor launches the kernel (and counts the launch in
    ``blend_instances_bwd.launches``), writing every element of ``out``
    (allocated when None); a CPU tensor runs the plain version."""
    _check_backward_inputs(inst_data, tile_starts, bg, img, t_final, g_img,
                           g_tfin, grid)
    if inst_data.device.type == "cpu":
        return blend_instances_backward_reference(
            inst_data, tile_starts, bg, img, t_final, g_img, g_tfin, grid, cut=cut)
    if inst_data.device.type != "cuda":
        raise ValueError(f"blend_instances_bwd runs on cuda or cpu, not {inst_data.device}")
    ins = (inst_data, tile_starts, img, t_final, g_img, g_tfin)
    if not all(x.is_contiguous() for x in ins):
        raise ValueError("blend_instances_bwd needs contiguous inputs")
    m = inst_data.shape[1]
    if out is None:
        out = torch.empty((ROW, m), dtype=torch.float32, device=inst_data.device)
    elif (out.dtype != torch.float32 or tuple(out.shape) != (ROW, m)
          or out.device != inst_data.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 [{ROW}, {m}] "
                         f"tensor on {inst_data.device}")
    ty, tx = grid
    buf = scratch("blend_instances_bwd", "blend_instances_bwd", m, ty * tx, inst_data.device)
    cuda_build.launch("blend_instances_bwd", "blend_instances_bwd", _BWD_ARGS, (
        inst_data.data_ptr(), m, tile_starts.data_ptr(), img.data_ptr(),
        t_final.data_ptr(), g_img.data_ptr(), g_tfin.data_ptr(), out.data_ptr(),
        ty * tx, tx, buf.data_ptr(), buf.numel(), None if cut is None else cut.data_ptr()),
        inst_data.device)
    blend_instances_bwd.launches += 1
    return out


blend_instances_bwd.launches = 0


def blend_instances_fwd(inst_data, tile_starts, bg, grid, cutoff=0.0):
    """The forward on one device, (img [T,3,P], t_final [T,P], cut): the
    kernel on CUDA (counted in ``blend_instances.launches``), the plain
    version on the CPU. ``cut`` is each tile's cut column (int32 [T]) when
    ``cutoff`` > 1e-4 (the early exit), else None."""
    _check_inputs(inst_data, tile_starts, bg, grid)
    if inst_data.device.type == "cpu":
        return _plain_forward(inst_data, tile_starts, bg, grid, cutoff)
    if inst_data.device.type != "cuda":
        raise ValueError(f"blend_instances runs on cuda or cpu, not {inst_data.device}")
    if not (inst_data.is_contiguous() and tile_starts.is_contiguous()
            and bg.is_contiguous()):
        raise ValueError("blend_instances needs contiguous inputs")
    ty, tx = grid
    T = ty * tx
    img = torch.empty((T, 3, P), dtype=torch.float32, device=inst_data.device)
    t_final = torch.empty((T, P), dtype=torch.float32, device=inst_data.device)
    m = inst_data.shape[1]
    buf = scratch("blend_instances", "blend_instances_fwd", m, T, inst_data.device)
    cut = cut_buf = None
    if cutoff > T_EPS:
        cut = torch.empty((T,), dtype=torch.int32, device=inst_data.device)
        cut_buf = scratch("blend_instances", "blend_instances_cut", m, T, inst_data.device)
    cuda_build.launch("blend_instances", "blend_instances_fwd", _FWD_ARGS, (
        inst_data.data_ptr(), m, tile_starts.data_ptr(), bg.data_ptr(),
        img.data_ptr(), t_final.data_ptr(), T, tx, buf.data_ptr(), buf.numel(),
        cutoff, None if cut is None else cut.data_ptr(),
        None if cut_buf is None else cut_buf.data_ptr(),
        0 if cut_buf is None else cut_buf.numel()), inst_data.device)
    blend_instances.launches += 1
    return img, t_final, cut


class _BlendInstances(torch.autograd.Function):
    """The blend with its backward (``_vjp_fwd`` / ``_vjp_bwd`` of the JAX
    package). ``plain`` runs both directions through the plain versions on
    any device (the comparisons of chip_smoke.py); otherwise the device
    picks kernel or plain version."""

    @staticmethod
    def forward(ctx, inst_data, tile_starts, bg, grid, plain, cutoff):
        fwd = _plain_forward if plain else blend_instances_fwd
        img, t_final, cut = fwd(inst_data, tile_starts, bg, grid, cutoff)
        # both directions use the forward's cut
        ctx.save_for_backward(inst_data, tile_starts, bg, img, t_final, cut)
        ctx.grid, ctx.plain = grid, plain
        return img, t_final

    @staticmethod
    def backward(ctx, g_img, g_tfin):
        inst_data, tile_starts, bg, img, t_final, cut = ctx.saved_tensors
        g_img, g_tfin = g_img.contiguous(), g_tfin.contiguous()
        bwd = blend_instances_backward_reference if ctx.plain else blend_instances_bwd
        g_inst = bwd(inst_data, tile_starts, bg, img, t_final, g_img, g_tfin, ctx.grid,
                     cut=cut)
        g_bg = torch.einsum("tdp,tp->d", g_img, t_final)
        return g_inst, None, g_bg, None, None, None


def blend_instances(inst_data, tile_starts, bg, grid, cutoff=0.0):
    """Instance-range blend. inst_data [16, M] float32 (see module
    docstring), tile_starts [T+1] int32 (compact or aligned ranges), bg [3]
    float32, grid (tiles_y, tiles_x). Returns (img_tiles [T,3,P], t_final
    [T,P]), differentiable in ``inst_data`` and ``bg``. ``cutoff`` > 1e-4:
    the chunk-granular early exit (:func:`window_cut`); <= 1e-4 the exact
    blend.

    A CUDA tensor launches the forward kernel (counted in
    ``blend_instances.launches``) and, in the backward, the backward kernel
    (``blend_instances_bwd.launches``); a CPU tensor runs the plain
    versions."""
    _check_inputs(inst_data, tile_starts, bg, grid)
    return _BlendInstances.apply(inst_data, tile_starts, bg, grid, False, cutoff)


blend_instances.launches = 0


def blend_instances_plain(inst_data, tile_starts, bg, grid, cutoff=0.0):
    """:func:`blend_instances` with both directions through the plain
    versions on any device: the yardstick the kernels are held against on
    the card."""
    _check_inputs(inst_data, tile_starts, bg, grid)
    return _BlendInstances.apply(inst_data, tile_starts, bg, grid, True, cutoff)
