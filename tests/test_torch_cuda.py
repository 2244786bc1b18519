"""Card-only tests of the port's CUDA kernels: each kernel (the instance
blend's and the dense-list blend's forward and backward) against its plain
PyTorch version on the card. They skip on a host without CUDA. They import
nothing of JAX, so on a machine with a card and no JAX they run as

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from torch_blend_cases import BLEND_CASES, blend_case
from torch_tile_cases import TILE_CASES, tile_case

from fateavatar_tpu_torch.render import blend_instances as tblend
from fateavatar_tpu_torch.render import blend_tiles as ttiles


def _cuda_inputs(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    inst, starts, bg, grid = blend_case(name)
    return (torch.from_numpy(inst).cuda(), torch.from_numpy(starts).cuda(),
            torch.from_numpy(bg).cuda(), grid)


@pytest.mark.cuda
@pytest.mark.parametrize("name", BLEND_CASES)
def test_blend_kernel_matches_plain_version(name):
    """Tolerance 2e-4: kernel and plain version take the transmittance
    product in another order, which can flip the instance that crosses
    T = 1e-4 at a pixel and move it by at most alpha * T <= 1e-4."""
    args = _cuda_inputs(name)
    before = tblend.blend_instances.launches
    img_k, tfin_k = tblend.blend_instances(*args)
    torch.cuda.synchronize()
    assert tblend.blend_instances.launches == before + 1
    img_p, tfin_p = tblend.blend_instances_reference(*args)
    assert (img_k - img_p).abs().max().item() <= 2e-4
    assert (tfin_k - tfin_p).abs().max().item() <= 2e-4
    if name == "empty":
        empty = (args[1][1:] - args[1][:-1]) == 0
        assert bool((tfin_k[empty] == 1.0).all())


def _cotangents(grid, seed=5):
    t = grid[0] * grid[1]
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(t, 3, 256)).astype(np.float32)).cuda(),
            torch.from_numpy(rng.normal(size=(t, 256)).astype(np.float32)).cuda())


def _close_rows(got, ref, rtol):
    """Each gradient row within ``rtol`` of that row's largest magnitude."""
    scale = ref[:9].abs().amax(dim=1, keepdim=True) + 1e-6
    return bool(((got[:9] - ref[:9]).abs() <= rtol * scale).all())


# Backward tolerance, relative to each gradient row's largest magnitude:
# the kernel sums each instance's 256 pixel terms in another order than the
# plain version (~1e-6 relative), and the two transmittance products can
# flip the instance that crosses T = 1e-4 at a pixel; that instance's term
# there carries T_j <= 1e-4 / (1 - 0.99), so 1e-3 covers one such flip.
BWD_RTOL = 1e-3


@pytest.mark.cuda
def test_blend_kernel_raises_on_cuda_grad():
    """The grad path on the card: autograd through blend_instances runs the
    forward and the backward kernel once each, and its gradients equal those
    of the plain versions (blend_instances_plain) within BWD_RTOL."""
    inst, starts, bg, grid = _cuda_inputs("empty")
    g_img, g_tfin = _cotangents(grid)

    def grads(blend):
        x, b = inst.clone().requires_grad_(), bg.clone().requires_grad_()
        img, tfin = blend(x, starts, b, grid)
        return torch.autograd.grad((img * g_img).sum() + (tfin * g_tfin).sum(), (x, b))

    f0, b0 = tblend.blend_instances.launches, tblend.blend_instances_bwd.launches
    gk, gbk = grads(tblend.blend_instances)
    torch.cuda.synchronize()
    assert tblend.blend_instances.launches == f0 + 1
    assert tblend.blend_instances_bwd.launches == b0 + 1
    gp, gbp = grads(tblend.blend_instances_plain)
    assert _close_rows(gk, gp, BWD_RTOL)
    assert (gbk - gbp).abs().max().item() <= 1e-3 * gbp.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("name", BLEND_CASES)
def test_blend_bwd_kernel_matches_plain_version(name):
    inst, starts, bg, grid = _cuda_inputs(name)
    img, tfin = tblend.blend_instances(inst, starts, bg, grid)
    g_img, g_tfin = _cotangents(grid)
    args = (inst, starts, bg, img, tfin, g_img, g_tfin, grid)
    before = tblend.blend_instances_bwd.launches
    gk = tblend.blend_instances_bwd(*args)
    torch.cuda.synchronize()
    assert tblend.blend_instances_bwd.launches == before + 1
    gp = tblend.blend_instances_backward_reference(*args)
    assert bool(torch.isfinite(gk).all())
    assert _close_rows(gk, gp, BWD_RTOL)
    assert bool((gk[9:] == 0).all())
    assert bool((gk[:, int(starts[-1]):] == 0).all()), "columns past the ranges"


@pytest.mark.cuda
def test_blend_bwd_kernel_writes_every_element():
    """A NaN-filled output buffer handed to the C entry point comes back
    finite and bit-equal to a clean call: no element is left unwritten."""
    inst, starts, bg, grid = _cuda_inputs("long")
    img, tfin = tblend.blend_instances(inst, starts, bg, grid)
    args = (inst, starts, bg, img, tfin, *_cotangents(grid), grid)
    clean = tblend.blend_instances_bwd(*args)
    dirty = tblend.blend_instances_bwd(*args, out=torch.full_like(clean, float("nan")))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dirty).all())
    assert torch.equal(dirty, clean)


def _cuda_tile_inputs(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    data, valid, counts, bg, grid = tile_case(name)
    return (*(torch.from_numpy(x).cuda() for x in (data, valid, counts, bg)), grid)


@pytest.mark.cuda
@pytest.mark.parametrize("route, name", [("instances", n) for n in BLEND_CASES]
                         + [("tiles", n) for n in sorted(TILE_CASES)])
def test_blend_kernels_are_bit_identical_across_calls(route, name):
    """Each route's kernels (1 and 2 on the compact cases, 3 and 4 on the
    dense ones) give the same bits on every call: each column and pixel is
    owned by one unit, and partial sums combine in a fixed order, whatever
    order the blocks run in."""
    if route == "instances":
        fwd_args = _cuda_inputs(name)
        fwd, bwd = tblend.blend_instances, tblend.blend_instances_bwd
    else:
        fwd_args = _cuda_tile_inputs(name)
        fwd, bwd = ttiles.blend_tiles, ttiles.blend_tiles_bwd
    *inputs, grid = fwd_args
    img, tfin = fwd(*fwd_args)
    img2, tfin2 = fwd(*fwd_args)
    args = (*inputs, img, tfin, *_cotangents(grid), grid)
    g, g2 = bwd(*args), bwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(img, img2) and torch.equal(tfin, tfin2)
    assert torch.equal(g, g2)


@pytest.mark.cuda
def test_tile_and_instance_kernels_agree_bit_for_bit():
    """The same lists through kernels 1 and 3 (the ``boundary`` blend case
    and its dense layout, the tile case ``boundary``) give the same bits:
    both kernels run the same segments, counted from each tile's start."""
    inst, starts, bg, grid = _cuda_inputs("boundary")
    data, valid, counts, bg_t, _ = _cuda_tile_inputs("boundary")
    img_i, tfin_i = tblend.blend_instances(inst, starts, bg, grid)
    img_t, tfin_t = ttiles.blend_tiles(data, valid, counts, bg_t, grid)
    torch.cuda.synchronize()
    assert torch.equal(img_i, img_t) and torch.equal(tfin_i, tfin_t)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_tile_kernel_matches_plain_version(name):
    """Kernel 3 against blend_tiles_reference, 2e-4 (a termination flip, as
    for the instance kernel); empty tiles keep T = 1."""
    args = _cuda_tile_inputs(name)
    before = ttiles.blend_tiles.launches
    img_k, tfin_k = ttiles.blend_tiles(*args)
    torch.cuda.synchronize()
    assert ttiles.blend_tiles.launches == before + 1
    img_p, tfin_p = ttiles.blend_tiles_reference(*args)
    assert (img_k - img_p).abs().max().item() <= 2e-4
    assert (tfin_k - tfin_p).abs().max().item() <= 2e-4
    assert bool((tfin_k[args[2] == 0] == 1.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_tile_bwd_kernel_matches_plain_version(name):
    """Kernel 4 against blend_tiles_backward_reference within BWD_RTOL of
    each row's largest element; zero past every list."""
    data, valid, counts, bg, grid = _cuda_tile_inputs(name)
    img, tfin = ttiles.blend_tiles(data, valid, counts, bg, grid)
    args = (data, valid, counts, bg, img, tfin, *_cotangents(grid), grid)
    before = ttiles.blend_tiles_bwd.launches
    gk = ttiles.blend_tiles_bwd(*args)
    torch.cuda.synchronize()
    assert ttiles.blend_tiles_bwd.launches == before + 1
    gp = ttiles.blend_tiles_backward_reference(*args)
    assert bool(torch.isfinite(gk).all())
    assert _close_rows(gk, gp, BWD_RTOL)
    k = data.shape[1] // counts.shape[0]
    past = torch.arange(k, device="cuda")[None, :] >= counts.clamp(max=k)[:, None]
    assert bool((gk[:, past.reshape(-1)] == 0).all()), "slots past the lists"


@pytest.mark.cuda
def test_tile_kernels_through_autograd():
    """Autograd through blend_tiles launches kernel 3 and kernel 4 once each,
    and its gradients equal those of the plain versions (blend_tiles_plain)
    within BWD_RTOL."""
    data, valid, counts, bg, grid = _cuda_tile_inputs("over_k")
    g_img, g_tfin = _cotangents(grid)

    def grads(blend):
        x, b = data.clone().requires_grad_(), bg.clone().requires_grad_()
        img, tfin = blend(x, valid, counts, b, grid)
        return torch.autograd.grad((img * g_img).sum() + (tfin * g_tfin).sum(), (x, b))

    f0, b0 = ttiles.blend_tiles.launches, ttiles.blend_tiles_bwd.launches
    gk, gbk = grads(ttiles.blend_tiles)
    torch.cuda.synchronize()
    assert ttiles.blend_tiles.launches == f0 + 1
    assert ttiles.blend_tiles_bwd.launches == b0 + 1
    gp, gbp = grads(ttiles.blend_tiles_plain)
    assert _close_rows(gk, gp, BWD_RTOL)
    assert (gbk - gbp).abs().max().item() <= 1e-3 * gbp.abs().max().item()


@pytest.mark.cuda
def test_tile_bwd_kernel_writes_every_element():
    """A NaN-filled output buffer comes back finite and bit-equal to a
    clean call: every slot of every list is written."""
    data, valid, counts, bg, grid = _cuda_tile_inputs("long")
    img, tfin = ttiles.blend_tiles(data, valid, counts, bg, grid)
    args = (data, valid, counts, bg, img, tfin, *_cotangents(grid), grid)
    clean = ttiles.blend_tiles_bwd(*args)
    dirty = ttiles.blend_tiles_bwd(*args, out=torch.full_like(clean, float("nan")))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dirty).all())
    assert torch.equal(dirty, clean)
