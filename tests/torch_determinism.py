"""Every sum of a CUDA step in one fixed order, for comparisons that must
be exact: a step eagerly against the same step replayed from a CUDA graph,
or two eager epochs. Atomic adds (``index_add_``, ``F.interpolate``'s
bilinear backward, cuBLAS's split reductions) sum in an order that changes
from run to run; inside :func:`deterministic_sums` none is left.
Shared by ``chip_smoke.py`` and the card-only tests."""

import os
import warnings
from contextlib import contextmanager

import torch
import torch.nn.functional as F


@contextmanager
def deterministic_sums():
    """Every sum of a step in one fixed order on the card, its forward
    values as they were: torch's deterministic algorithms (``index_add_`` as a sorted
    ``index_put_``, cuBLAS on a fixed workspace) and ``F.interpolate``'s
    bilinear backward, which torch has only with atomics, as products with
    the resampling matrices' transposes (the matrices are the forward's own
    weights: ``F.interpolate`` of an identity along one axis, checked
    against the forward the first time a pair is used). Yields a list that holds,
    on exit, the ops torch still flagged as nondeterministic (warned, not
    raised, so that the comparison runs and says which). Restored on
    exit."""
    orig = F.interpolate
    mats = {}

    def matrix(n_in, n_out, kw, device):
        key = (n_in, n_out, kw["mode"], kw["align_corners"], kw["antialias"], device)
        if key not in mats:
            # rows resampled, columns at scale 1 (weight 1 on the column)
            eye = torch.eye(n_in, device=device)[None, None]
            mats[key] = orig(eye, size=(n_out, n_in), mode=kw["mode"],
                             align_corners=kw["align_corners"],
                             antialias=kw["antialias"])[0, 0].contiguous()   # [n_out, n_in]
        return mats[key]

    checked = set()

    class Resample(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, kw):
            y = orig(x, **kw)
            ctx.mh = matrix(x.shape[2], y.shape[2], kw, x.device)
            ctx.mw = matrix(x.shape[3], y.shape[3], kw, x.device)
            pair = (tuple(x.shape), tuple(y.shape), kw["antialias"])
            capturing = x.is_cuda and torch.cuda.is_current_stream_capturing()
            if pair not in checked and not capturing:
                err = float((ctx.mh @ x @ ctx.mw.T - y).abs().max())
                if err > 1e-5 * (float(y.abs().max()) + 1e-12):
                    raise RuntimeError(f"the resampling matrices do not reproduce "
                                       f"F.interpolate {pair}: {err:.1e}")
                checked.add(pair)
            return y

        @staticmethod
        def backward(ctx, gy):
            return ctx.mh.T @ gy @ ctx.mw, None

    def interpolate(x, size=None, scale_factor=None, mode="nearest", align_corners=None,
                    recompute_scale_factor=None, antialias=False):
        kw = {"size": size, "scale_factor": scale_factor, "mode": mode,
              "align_corners": align_corners, "recompute_scale_factor": recompute_scale_factor,
              "antialias": antialias}
        if mode != "bilinear" or not (torch.is_grad_enabled() and x.requires_grad):
            return orig(x, **kw)
        return Resample.apply(x, kw)

    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.utils.deterministic.fill_uninitialized_memory,
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    flagged = []
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    F.interpolate = interpolate
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield flagged
        flagged.extend(sorted({str(w.message)[:100] for w in caught
                               if "determinis" in str(w.message)}))
    finally:
        F.interpolate = orig
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.utils.deterministic.fill_uninitialized_memory = saved[2]
        if saved[3] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[3]
