"""Seeded trials of the port's device-tier fuzz suite, shared by
``test_torch_fuzz_device.py`` (the port on the CPU against tci_tpu) and
``test_torch_cuda.py`` (the port's tiers on the card against the CPU).

Each ``*_case(trial)`` draws trial `trial` of one of ``tests/test_fuzz_device
.py``'s seven sweeps from the same master seed with the same draws (the
earlier trials' draws are made again and thrown away), so a trial of the
port and the same trial of tci_tpu see the same shapes, knobs and numbers.
Each ``run_*(case, device)`` runs the port's device tier and its host
oracle on `device` and returns what the tests compare, as numpy. This
module imports neither jax nor tci_tpu.
"""

import numpy as np
import torch

import tci_tpu_torch as tci
from tci_tpu_torch.models import conversion
from tci_tpu_torch.models.compress_device import compress_device
from tci_tpu_torch.models.contraction import contract
from tci_tpu_torch.models.globalsearch import (_floatingzone_batch,
                                               estimatetrueerror)
from tci_tpu_torch.models.tensortrain import TensorTrain, fulltensor

# trials of each sweep, as in tests/test_fuzz_device.py
NTRIALS = {"compress": 10, "contraction": 8, "rook": 5, "complex": 5,
           "conversion": 4, "floatingzone": 4, "tci1": 4}


def _nth(draws, trial):
    for k, case in enumerate(draws()):
        if k == trial:
            return case
    raise IndexError(trial)


def _full(tt) -> np.ndarray:
    return fulltensor(tt).cpu().numpy()


def _grid(localdims):
    return np.stack([g.ravel() for g in np.meshgrid(
        *[np.arange(d) for d in localdims], indexing="ij")], axis=1)


# -- compression ---------------------------------------------------------------

def _lowrank_cores(rng, L, chi, d, r, complex_=False, ndeficient=0):
    """Random TT cores of true bond rank <= r inside chi-wide bonds; the
    first ``ndeficient`` cores get an exactly repeated local channel (exact
    rank deficiency)."""
    bonds = [1] + [chi] * (L - 1) + [1]
    ts = []
    for n in range(L):
        u = rng.standard_normal((bonds[n], d, r))
        v = rng.standard_normal((r, bonds[n + 1]))
        if complex_:
            u = u + 1j * rng.standard_normal(u.shape)
            v = v + 1j * rng.standard_normal(v.shape)
        t = (u @ v) / np.sqrt(r)
        if n < ndeficient and d >= 2:
            t[:, 1, :] = t[:, 0, :]
        ts.append(t)
    return ts


def compress_case(trial):
    def draws():
        master = np.random.default_rng(424242)
        for k in range(NTRIALS["compress"]):
            L = int(master.integers(3, 8))
            chi = int(master.integers(2, 10))
            d = int(master.integers(2, 5))
            r = int(master.integers(1, chi + 1))
            complex_ = bool(master.integers(0, 2))
            ndef = int(master.integers(0, 2)) * int(master.integers(0, L))
            tolerance = [0.0, 1e-10, 1e-6, 1e-3][int(master.integers(0, 4))]
            mbd = (int(master.integers(1, 2 * chi)) if master.integers(0, 2)
                   else 10**9)
            normerr = bool(master.integers(0, 2))
            cores = _lowrank_cores(master, L, chi, d, r, complex_=complex_,
                                   ndeficient=ndef)
            yield {"cfg": (k, L, chi, d, r, complex_, ndef, tolerance, mbd,
                           normerr),
                   "cores": cores, "kw": {"tolerance": tolerance,
                                          "maxbonddim": mbd,
                                          "normalizeerror": normerr}}
    return _nth(draws, trial)


def run_compress(case, device):
    """(host linkdims, host full tensor, device linkdims, device full
    tensor): compress("LU") and compress_device of the case's train."""
    tt = TensorTrain(case["cores"], device=device)
    host = tt.copy()
    host.compress("LU", **case["kw"])
    dev = compress_device(tt, "LU", **case["kw"])
    return host.linkdims(), _full(host), dev.linkdims(), _full(dev)


# -- contraction ---------------------------------------------------------------

def _mpo_cores(rng, L, chi, d1, d2, complex_=False):
    bonds = [1] + [chi] * (L - 1) + [1]
    ts = []
    for n in range(L):
        t = rng.standard_normal((bonds[n], d1, d2, bonds[n + 1]))
        if complex_:
            t = t + 1j * rng.standard_normal(t.shape)
        ts.append(t / np.sqrt(chi))
    return ts


def contraction_case(trial):
    def draws():
        master = np.random.default_rng(515151)
        for k in range(NTRIALS["contraction"]):
            L = int(master.integers(3, 6))
            chiA = int(master.integers(2, 5))
            chiB = int(master.integers(2, 5))
            d1 = int(master.integers(2, 4))
            dm = int(master.integers(2, 4))
            d2 = int(master.integers(2, 4))
            complex_ = bool(master.integers(0, 2))
            algorithm = ["naive", "zipup"][int(master.integers(0, 2))]
            tolerance = [1e-12, 1e-8, 1e-4][int(master.integers(0, 3))]
            mbd = (int(master.integers(2, 12)) if master.integers(0, 2)
                   else 10**9)
            A = _mpo_cores(master, L, chiA, d1, dm, complex_=complex_)
            B = _mpo_cores(master, L, chiB, dm, d2, complex_=complex_)
            # a binding maxbonddim on an incompressible random product: the
            # device naive tier truncates bond by bond during the merge, the
            # host by one two-pass compression; both are valid rank-mbd
            # truncations but not the same one, so only the cap and
            # finiteness are compared
            # (test_contraction_device.py::test_device_naive_maxbonddim)
            capped = algorithm == "naive" and mbd < chiA * chiB
            yield {"cfg": (k, L, chiA, chiB, d1, dm, d2, complex_, algorithm,
                           tolerance, mbd),
                   "A": A, "B": B, "capped": capped, "mbd": mbd,
                   "kw": {"algorithm": algorithm, "tolerance": tolerance,
                          "maxbonddim": mbd, "method": "LU"}}
    return _nth(draws, trial)


def run_contraction(case, device):
    A = TensorTrain(case["A"], device=device)
    B = TensorTrain(case["B"], device=device)
    host = contract(A, B, **case["kw"])
    dev = contract(A, B, torch_native=True, **case["kw"])
    return host.linkdims(), _full(host), dev.linkdims(), _full(dev)


# -- rook on the engine ----------------------------------------------------------

def rook_case(trial):
    def draws():
        master = np.random.default_rng(616161)
        for k in range(NTRIALS["rook"]):
            L = int(master.integers(3, 6))
            localdims = [int(master.integers(2, 5)) for _ in range(L)]
            c = master.standard_normal(L) * 0.5
            w = 1.0 + master.random(L)
            yield {"cfg": (k, localdims), "trial": k, "localdims": localdims,
                   "c": c, "w": w}
    return _nth(draws, trial)


def rook_exact(case) -> np.ndarray:
    """The rook sweep's f on its whole grid, with numpy."""
    c, w, dims = case["c"], case["w"], case["localdims"]
    v = _grid(dims).astype(float)
    return (1.0 / (1.0 + ((v - c) ** 2 * w).sum(1))
            + 0.1 * np.cos((v * w).sum(1))).reshape(dims)


def run_rook(case, device):
    """Rook on the engine, to 1e-9: (linkdims, ranks, errors, full tensor,
    the engine's rrLU calls)."""
    dev = torch.device(device)
    c = torch.as_tensor(case["c"], device=dev)
    w = torch.as_tensor(case["w"], device=dev)

    def f(idx):
        v = idx.to(torch.float64)
        return (1.0 / (1.0 + (w * (v - c) ** 2).sum(1))
                + 0.1 * torch.cos((v * w).sum(1)))

    bf = tci.TorchBatchEvaluator(f, case["localdims"], device=dev)
    t, ranks, errors = tci.crossinterpolate2(
        np.float64, bf, case["localdims"], tolerance=1e-9,
        pivotsearch="rook", rng=np.random.default_rng(case["trial"]),
        device=dev)
    return (t.linkdims(), ranks, errors, _full(tci.tensortrain(t)),
            bf.device_sweep_engine.rrlu_calls)


# -- complex128 on the engine ------------------------------------------------------

def complex_case(trial):
    def draws():
        master = np.random.default_rng(717171)
        for k in range(NTRIALS["complex"]):
            L = int(master.integers(3, 6))
            localdims = [int(master.integers(2, 5)) for _ in range(L)]
            tolerance = float(10.0 ** -master.integers(7, 11))
            strict = bool(master.integers(0, 2))
            c = master.standard_normal(L) * 0.4
            w = 1.0 + master.random(L)
            yield {"cfg": (k, localdims, tolerance, strict), "trial": k,
                   "localdims": localdims, "c": c, "w": w,
                   "kw": {"tolerance": tolerance, "strictlynested": strict}}
    return _nth(draws, trial)


def complex_scalar(case):
    """The complex sweep's f at one multi-index, with numpy: the host
    oracle's scalar f (tci_tpu's gpy)."""
    c, w = case["c"], case["w"]

    def gpy(x):
        v = np.asarray(x, float) + 1.0
        s = float(np.sum(v * w))
        den = 1.0 + float(np.sum(w * (v - c) ** 2))
        return complex(np.cos(s) / den, np.sin(s) / den)
    return gpy


def run_complex(case, device):
    """The complex128 engine (the optimize loop) and the host tier's scalar
    f: (engine linkdims, engine full tensor, host linkdims, host full
    tensor)."""
    dev = torch.device(device)
    c = torch.as_tensor(case["c"], device=dev)
    w = torch.as_tensor(case["w"], device=dev)

    def g(idx):
        v = idx.to(torch.float64) + 1.0
        return torch.polar(1.0 / (1.0 + (w * (v - c) ** 2).sum(1)),
                           (v * w).sum(1))

    bf = tci.TorchBatchEvaluator(g, case["localdims"],
                                 dtype=torch.complex128, device=dev)
    t1, _, _ = tci.crossinterpolate2(
        np.complex128, bf, case["localdims"],
        rng=np.random.default_rng(case["trial"]), device=dev, **case["kw"])
    assert bf.device_sweep_engine.rrlu_calls > 0
    t2, _, _ = tci.crossinterpolate2(
        np.complex128, complex_scalar(case), case["localdims"],
        rng=np.random.default_rng(case["trial"]), device=dev, **case["kw"])
    return (t1.linkdims(), _full(tci.tensortrain(t1)), t2.linkdims(),
            _full(tci.tensortrain(t2)))


# -- conversions -----------------------------------------------------------------

def _smooth_scalar(c, complex_):
    if complex_:
        def fpy(x):
            v = np.asarray(x, float) + 1.0
            return np.exp(1j * v.sum()) / (1.0 + np.sum((v - c) ** 2))
        return fpy, np.complex128

    def fpy(x):
        v = np.asarray(x, float)
        return 1.0 / (1.0 + np.sum((v - c) ** 2))
    return fpy, np.float64


def conversion_case(trial):
    def draws():
        master = np.random.default_rng(818181)
        for k in range(NTRIALS["conversion"]):
            L = int(master.integers(3, 6))
            localdims = [int(master.integers(2, 5)) for _ in range(L)]
            complex_ = bool(master.integers(0, 2))
            c = master.standard_normal(L) * 0.5
            f, vt = _smooth_scalar(c, complex_)
            yield {"cfg": (k, localdims, complex_), "trial": k,
                   "localdims": localdims, "f": f, "vt": vt}
    return _nth(draws, trial)


def run_conversion(case, device):
    """TCI2 (host tier, tolerance 1e-10), TT -> TCI2, TCI2 -> TCI1 -> TCI2:
    each result's linkdims and full tensor."""
    t2, _, _ = tci.crossinterpolate2(
        case["vt"], case["f"], case["localdims"], tolerance=1e-10,
        rng=np.random.default_rng(case["trial"]), device=device)
    tb = conversion.tci2_from_tensortrain(tci.tensortrain(t2),
                                          tolerance=1e-12)
    t1 = conversion.tci1_from_tci2(t2, case["f"])
    t2b = conversion.tci2_from_tci1(t1)
    return {name: (t.linkdims(), _full(tci.tensortrain(t)))
            for name, t in (("tci2", t2), ("from_tt", tb), ("tci1", t1),
                            ("back", t2b))}


# -- the floating-zone search --------------------------------------------------------

def floatingzone_case(trial):
    """The starts are drawn after the TCI in tci_tpu's sweep; they depend
    on nothing the TCI does, so they are drawn here with the rest."""
    def draws():
        master = np.random.default_rng(919191)
        for k in range(NTRIALS["floatingzone"]):
            L = int(master.integers(4, 7))
            d = int(master.integers(2, 5))
            w = 1.0 + master.random(L)
            starts = [tuple(int(x) for x in row)
                      for row in master.integers(0, d, (10, L))]
            yield {"cfg": (k, L, d), "trial": k, "localdims": [d] * L,
                   "w": w, "starts": starts}
    return _nth(draws, trial)


def floatingzone_np(case):
    """The floating-zone sweep's f on a (B, L) index matrix, with numpy."""
    w = case["w"]

    def f(idx):
        v = np.asarray(idx, float) + 1.0
        return (1.0 / (1.0 + (w * v * v).sum(1))
                + 0.05 * np.cos(3.1 * (v * w).sum(1)))
    return f


def run_floatingzone(case, device):
    """The engine's TCI (tolerance 1e-2, maxbonddim 3), then the search
    from the case's starts by the engine's floating-zone program and by
    the host lock-step search: (linkdims, device results, host results)."""
    dev = torch.device(device)
    w = torch.as_tensor(case["w"], device=dev)

    def f(idx):
        v = idx.to(torch.float64) + 1.0
        return (1.0 / (1.0 + (w * v * v).sum(1))
                + 0.05 * torch.cos(3.1 * (v * w).sum(1)))

    bf = tci.TorchBatchEvaluator(f, case["localdims"], device=dev)
    t, _, _ = tci.crossinterpolate2(
        np.float64, bf, case["localdims"], tolerance=1e-2, maxbonddim=3,
        rng=np.random.default_rng(case["trial"]), device=dev)
    tt = tci.tensortrain(t)
    found = estimatetrueerror(tt, bf, initialpoints=case["starts"])
    host = _floatingzone_batch(tt, bf, case["starts"])
    assert any(key[0] == "fzone" for key in bf.device_sweep_engine._sweeps)
    return t.linkdims(), found, host


# -- TCI1 ------------------------------------------------------------------------------

def tci1_case(trial):
    def draws():
        master = np.random.default_rng(101010)
        for k in range(NTRIALS["tci1"]):
            L = int(master.integers(3, 6))
            localdims = [int(master.integers(2, 5)) for _ in range(L)]
            complex_ = bool(master.integers(0, 2))
            strategy = ["forward", "backandforth"][int(master.integers(0, 2))]
            c = master.standard_normal(L) * 0.5
            f, vt = _smooth_scalar(c, complex_)
            yield {"cfg": (k, localdims, complex_, strategy),
                   "localdims": localdims, "f": f, "vt": vt,
                   "kw": {"tolerance": 1e-10, "maxiter": 30,
                          "sweepstrategy": strategy}}
    return _nth(draws, trial)


def tci1_exact(case) -> np.ndarray:
    pts = _grid(case["localdims"])
    return np.asarray([case["f"](p) for p in pts]).reshape(case["localdims"])


def run_tci1(case, device):
    """crossinterpolate1 from the zero pivot: (ranks, errors, linkdims,
    full tensor)."""
    t1, ranks, errors = tci.crossinterpolate1(
        case["vt"], case["f"], case["localdims"], [0] * len(case["localdims"]),
        device=device, **case["kw"])
    return ranks, errors, t1.linkdims(), _full(tci.tensortrain(t1))
