"""High-dimensional integration: Gauss-Kronrod grids x TCI2 x factorized sum.

Counterpart of ``tci_tpu/models/integration.py`` (parity reference:
src/integration.jl). The GK nodes and weights come from ``ops/kronrod.py``.

``torch_native=True`` takes the place of ``jax_native=True``: the weighted
integrand is sampled on the device through a ``TorchBatchEvaluator``, so
TCI2 runs it on the whole-sweep engine by default. Like ``tci_tpu``
(``_GK_EVAL_CACHE``) it keeps the evaluator across calls: the engine's CUDA
graphs belong to the evaluator, so a second ``integrate`` on the same f,
bounds, GK order, type and device only replays them. The cache is keyed
weakly on f and drops an entry when f is collected. Two things of
``tci_tpu``'s jax-native branch have no counterpart here:

- the one-hot node and weight lookup, a workaround for slow table gathers
  on a TPU: the nodes and weights are gathered by index;
- ``fused_panel_capacity=True``, which bounds the number of programs XLA
  compiles for the fused tier: eager PyTorch compiles nothing per shape and
  the port's fused tier has no such mode.

``mesh=`` (a ``parallel.mesh`` DeviceMesh; every rank calls with the same
arguments) shards the evaluator's sampling over the mesh's ranks, as
``tci_tpu``'s does; it requires ``torch_native=True``.
"""

from __future__ import annotations

import weakref
from typing import Callable, Sequence

import numpy as np
import torch

from ..ops.kronrod import kronrod
from ..parallel.batcheval import TorchBatchEvaluator, VectorizedBatchEvaluator
from ..utils.device import resolve_device, to_device
from .tensorci2 import crossinterpolate2

# torch_native evaluators by integrand (weakly), then by (GK order, bounds,
# value type, device, engine on or off): one slot per signature, so two
# grids on one f keep both evaluators
_GK_EVAL_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _torch_native_evaluator(f, nodes, weights, normalization, localdims,
                            valuetype, device, enable_device_sweep, mesh):
    """The weighted integrand on the GK grid as a ``TorchBatchEvaluator``.
    It refers to f weakly: the cache that holds it is keyed weakly on f, and
    an entry whose value kept its key alive would never go."""
    nodes_d = to_device(nodes, device)
    weights_d = to_device(weights, device)
    dims_d = torch.arange(nodes.shape[0], device=device)
    try:
        fref = weakref.ref(f)
    except TypeError:  # not cached either (see integrate)
        def fref():
            return f

    def Ftorch(idx):
        x = nodes_d[dims_d, idx]  # (B, N) coordinates
        wn = weights_d[dims_d, idx]
        # the product in a fixed left-to-right order; a zero weight
        # (degenerate bounds a_n == b_n) gives an exact zero
        w = wn[:, 0]
        for n in range(1, wn.shape[1]):
            w = w * wn[:, n]
        return w * fref()(x) * normalization

    return TorchBatchEvaluator(Ftorch, localdims, dtype=valuetype,
                               device=device,
                               enable_device_sweep=enable_device_sweep,
                               mesh=mesh)


def integrate(
    valuetype,
    f: Callable,
    a: Sequence[float],
    b: Sequence[float],
    GKorder: int = 15,
    torch_native: bool = False,
    vectorized: bool = False,
    enable_device_sweep: bool = True,
    mesh=None,
    device=None,
    **kwargs,
):
    """∫_a^b f(x) d^N x via TCI2 over a tensor-product GK grid
    (integration.jl:68-161).

    GKorder must be odd (2n+1 Kronrod points with n = GKorder // 2 Gauss
    points). Additional kwargs go to crossinterpolate2 (e.g. tolerance).
    TCI2 runs on `device`: the current CUDA device by default, and a
    RuntimeError without one unless ``device="cpu"`` is given.

    By default `f` takes one coordinate vector (a list of N floats) and is
    sampled point by point on the host.

    With torch_native=True, `f` maps a (B, N) coordinate tensor on `device`
    to (B,) values there, written with torch operations; the weighted
    integrand is then sampled on the device and, unless
    ``enable_device_sweep=False``, the sweeps run on the whole-sweep engine.
    The weight of a grid point is the product of its N one-dimensional
    weights taken from left to right, which is how the vectorized path's
    ``np.prod`` rounds.

    With vectorized=True (host sampling), `f` must accept a (B, N) numpy
    coordinate matrix and return (B,) values; each Π panel is then one
    numpy call instead of B Python-level point evaluations.
    """
    if GKorder % 2 == 0:
        raise ValueError("Gauss--Kronrod order must be odd, e.g. 15 or 61.")
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    if len(a) != len(b):
        raise ValueError(
            f"Integral bounds must have the same dimensionality, got "
            f"{len(a)} lower and {len(b)} upper bounds."
        )
    if mesh is not None and not torch_native:
        raise ValueError(
            "mesh= shards the device sampling path; it requires "
            "torch_native=True (host-sampled tiers ignore the mesh).")

    nodes1d, weights1d, _ = kronrod(GKorder // 2)
    # affine map [-1, 1] -> [a_n, b_n] per dimension
    nodes = (b[:, None] - a[:, None]) * (nodes1d[None, :] + 1) / 2 + a[:, None]
    weights = (b[:, None] - a[:, None]) * weights1d[None, :] / 2
    normalization = float(GKorder) ** len(a)
    localdims = [len(nodes1d)] * len(a)
    kwargs.setdefault("nsearchglobalpivot", 10)

    if torch_native:
        device = resolve_device(device)
        # the cached evaluator holds the mesh, so its id is not reused
        # while the entry lives
        cache_key = (GKorder, tuple(a.tolist()), tuple(b.tolist()),
                     np.dtype(valuetype).str, str(device),
                     enable_device_sweep, None if mesh is None else id(mesh))
        try:
            slots = _GK_EVAL_CACHE.setdefault(f, {})
        except TypeError:  # an integrand that cannot be referenced weakly
            slots = {}
        F = slots.get(cache_key)
        if F is None:
            F = slots[cache_key] = _torch_native_evaluator(
                f, nodes, weights, normalization, localdims, valuetype,
                device, enable_device_sweep, mesh)
        else:
            F.reset_nevals()
    elif vectorized:
        dims = np.arange(len(a))

        def Fvec(idx):
            X = nodes[dims[None, :], idx]  # (B, N) coordinates
            W = np.prod(weights[dims[None, :], idx], axis=1)
            y = np.asarray(f(X))
            if y.shape != (X.shape[0],):
                raise ValueError(
                    f"vectorized integrand must map a (B, N) coordinate "
                    f"matrix to shape (B,) = ({X.shape[0]},); got {y.shape}. "
                    f"Pass vectorized=False for a per-point integrand."
                )
            return W * y * normalization

        F = VectorizedBatchEvaluator(Fvec, localdims, dtype=valuetype)
    else:
        def F(indices):
            x = [nodes[n, i] for n, i in enumerate(indices)]
            w = float(np.prod([weights[n, i] for n, i in enumerate(indices)]))
            return w * f(x) * normalization

    tci2, ranks, errors = crossinterpolate2(valuetype, F, localdims,
                                            device=device, **kwargs)
    return tci2.sum() / normalization
