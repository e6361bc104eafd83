"""Conversions between TCI1, TCI2, TensorTrain and matrix factorizations.

Counterpart of ``tci_tpu/models/conversion.py`` (parity reference:
src/conversion.jl). Each conversion runs on the device of what it converts:
a TCI's ``device``, or the device of a train's cores. ``sweep1sitegetindices``
factorizes every bond through ``MatrixLUCI``, so a train on a CUDA device
launches the rrLU kernel once a bond and sweep.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.aca import MatrixACA
from ..ops.lu import rrLU
from ..ops.luci import MatrixLUCI
from ..utils.device import to_device
from ..utils.indexset import IndexSet
from .tensorci1 import TensorCI1
from .tensorci2 import TensorCI2, kronecker_is, kronecker_sj
from .tensortrain import TensorTrain

MultiIndex = Tuple[int, ...]

_INTMAX = 2**62


def aca_from_rrlu(lu: rrLU) -> MatrixACA:
    """Convert an rrLU factorization into ACA form (conversion.jl:45-74), on
    the factors' device."""
    aca = MatrixACA(nrows=lu.shape[0], ncols=lu.shape[1], dtype=lu.L.dtype,
                    device=lu.L.device)
    aca.rowindices = [int(i) for i in lu.rowindices()]
    aca.colindices = [int(j) for j in lu.colindices()]
    d = to_device(lu.diag(), lu.L.device).to(lu.L.dtype)
    aca.alpha = 1.0 / d
    if lu.leftorthogonal:
        aca.u = lu.left() * d[None, :]
        aca.v = lu.right().clone()
    else:
        aca.u = lu.left().clone()
        aca.v = lu.right() * d[:, None]
    return aca


def tci1_from_tci2(tci2: TensorCI2, f) -> TensorCI1:
    """Rebuild a TCI1 (with full Π matrices) from TCI2 index sets on the
    TCI2's device; f re-samples Π (conversion.jl:99-155), one batched call a
    bond for an evaluator with ``evaluate_many``."""
    L = len(tci2)
    tci1 = TensorCI1(tci2.localdims, dtype=tci2.dtype, device=tci2.device)
    tci1.Iset = [IndexSet(s) for s in tci2.Iset]
    tci1.Jset = [IndexSet(s) for s in tci2.Jset]
    tci1.PiIset = [tci1.getPiIset(p) for p in range(L)]
    tci1.PiJset = [tci1.getPiJset(p) for p in range(L)]
    tci1.Pi = [tci1.getPi(p, f) for p in range(L - 1)] + [
        tci1._zeros((0, 0))]

    for ell in range(L - 1):
        iset = [tci1.PiIset[ell].pos(i) for i in tci1.Iset[ell + 1].fromint]
        jset = [tci1.PiJset[ell + 1].pos(j) for j in tci1.Jset[ell].fromint]
        rows = to_device(np.asarray(iset, dtype=np.int64), tci1.device)
        cols = to_device(np.asarray(jset, dtype=np.int64), tci1.device)
        Pi = tci1.Pi[ell]
        tci1.updateT(ell, Pi[:, cols])
        if ell == L - 2:
            tci1.updateT(L - 1, Pi[rows, :])
        tci1.P[ell] = Pi[rows][:, cols]
        tci1.aca[ell] = MatrixACA(A=Pi, firstpivot=(iset[0], jset[0]))
        for rowindex, colindex in zip(iset[1:], jset[1:]):
            tci1.aca[ell].addpivotcol(Pi, colindex)
            tci1.aca[ell].addpivotrow(Pi, rowindex)

    tci1.P[L - 1] = torch.ones((1, 1), dtype=tci1.dtype, device=tci1.device)
    tci1.pivoterrors = np.asarray(tci2.bonderrors, dtype=float).copy()
    tci1.maxsamplevalue = tci2.maxsamplevalue
    return tci1


def tci2_from_tci1(tci1: TensorCI1) -> TensorCI2:
    """Convert TCI1 to TCI2 on the TCI1's device (no f needed;
    conversion.jl:177-200)."""
    tci2 = TensorCI2(tci1.localdims, dtype=tci1.dtype, device=tci1.device)
    tci2.Iset = [list(s.fromint) for s in tci1.Iset]
    tci2.Jset = [list(s.fromint) for s in tci1.Jset]
    L = len(tci1)
    for p in range(L - 1):
        tci2._sitetensors[p] = tci1.TtimesPinv(p)
    tci2._sitetensors[L - 1] = tci1.T[L - 1]
    tci2.pivoterrors = []
    tci2.bonderrors = np.asarray(tci1.pivoterrors, dtype=float).copy()
    tci2.maxsamplevalue = tci1.maxsamplevalue
    return tci2


def sweep1sitegetindices(
    tt: TensorTrain,
    forwardsweep: bool,
    spectatorindices: Optional[List[List[MultiIndex]]] = None,
    maxbonddim: int = _INTMAX,
    tolerance: float = 0.0,
):
    """One LUCI sweep over a raw TT, extracting pivot index sets in place
    (conversion.jl:221-308). Mutates tt into (left/right) canonical form.
    Each bond's factorization runs where the cores lie: the rrLU kernel on
    a CUDA device."""
    indexset: List[List[MultiIndex]] = [[()]]
    pivoterrorsarray = np.zeros(tt.rank() + 1)

    def groupindices(T: torch.Tensor, nxt: bool) -> torch.Tensor:
        shape = T.shape
        if forwardsweep != nxt:
            return T.reshape(int(np.prod(shape[:-1])), shape[-1])
        return T.reshape(shape[0], int(np.prod(shape[1:])))

    def splitindices(T: torch.Tensor, shape, newbonddim: int, nxt: bool):
        if forwardsweep != nxt:
            newshape = (*shape[:-1], newbonddim)
        else:
            newshape = (newbonddim, *shape[1:])
        return T.reshape(newshape)

    L = len(tt)
    tensors = tt._sitetensors
    for i in range(L - 1):
        ell = i if forwardsweep else L - 1 - i
        ellnext = i + 1 if forwardsweep else L - 2 - i
        shape = tensors[ell].shape
        shapenext = tensors[ellnext].shape

        luci = MatrixLUCI(
            groupindices(tensors[ell], False),
            leftorthogonal=forwardsweep,
            abstol=tolerance,
            maxrank=maxbonddim,
        )

        if forwardsweep:
            kron = kronecker_is(indexset[-1], shape[1])
            indexset.append([kron[r] for r in luci.rowindices()])
            if spectatorindices:
                spectatorindices[ell] = [
                    spectatorindices[ell][c] for c in luci.colindices()
                ]
        else:
            kron = kronecker_sj(shape[1], indexset[-1])
            indexset.append([kron[c] for c in luci.colindices()])
            if spectatorindices:
                spectatorindices[ell] = [
                    spectatorindices[ell][r] for r in luci.rowindices()
                ]

        tensors[ell] = splitindices(
            luci.left() if forwardsweep else luci.right(),
            shape, luci.npivots(), False,
        )
        if forwardsweep:
            nexttensor = luci.right() @ groupindices(tensors[ellnext], True)
        else:
            nexttensor = groupindices(tensors[ellnext], True) @ luci.left()
        tensors[ellnext] = splitindices(
            nexttensor, shapenext, luci.npivots(), True
        )

        perrs = luci.pivoterrors()
        npe = luci.npivots() + 1
        if npe > len(pivoterrorsarray):
            pivoterrorsarray = np.concatenate(
                [pivoterrorsarray, np.zeros(npe - len(pivoterrorsarray))]
            )
        pivoterrorsarray[:npe] = np.maximum(pivoterrorsarray[:npe], perrs[:npe])

    if forwardsweep:
        return indexset, pivoterrorsarray
    return indexset[::-1], pivoterrorsarray


def tci2_from_tensortrain(
    tt: TensorTrain,
    f=None,
    tolerance: float = 1e-12,
    maxbonddim: int = _INTMAX,
    maxiter: int = 3,
) -> TensorCI2:
    """Extract TCI2 index sets from a raw TT by alternating LUCI sweeps
    (conversion.jl:340-379), on the device of tt's cores. Mutates a copy of
    tt."""
    tt = tt.copy()
    Iset, _ = sweep1sitegetindices(
        tt, True, maxbonddim=maxbonddim, tolerance=tolerance
    )
    Jset, pivoterrors = sweep1sitegetindices(
        tt, False, maxbonddim=maxbonddim, tolerance=tolerance
    )

    for it in range(3, maxiter + 1):
        if it % 2 == 1:
            Isetnew, pivoterrors = sweep1sitegetindices(tt, True, Jset)
            if Isetnew == Iset:
                break
            Iset = Isetnew
        else:
            Jsetnew, pivoterrors = sweep1sitegetindices(tt, False, Iset)
            if Jsetnew == Jset:
                break
            Jset = Jsetnew

    tensors = list(tt.sitetensors())
    tci2 = TensorCI2([d[0] for d in tt.sitedims()], dtype=tensors[0].dtype,
                     device=tensors[0].device)
    tci2.Iset = [list(s) for s in Iset]
    tci2.Jset = [list(s) for s in Jset]
    tci2._sitetensors = tensors
    tci2.pivoterrors = list(pivoterrors)
    tci2.maxsamplevalue = float(torch.stack(
        [t.abs().amax() for t in tensors]).amax())
    return tci2
