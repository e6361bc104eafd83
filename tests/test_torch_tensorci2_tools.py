"""The TCI2 pivot tools of tci_tpu_torch against tci_tpu's (the port on
device="cpu"): kronecker, existaspivot, sweep0site, makecanonical,
addglobalpivots1sitesweep / 2sitesweep and searchglobalpivots, on the host
tier of both packages from the same state; and the port's engine tier (the
floating-zone program, the engine's sweeps) against its host tier.

Tolerances: index sets, ranks, returned pivots and counts identical; site
tensors within 1e-12 of their largest entry, or eps * cond(P) where the
pivot block P of a site tensor T = Π1 · P^{-1} is worse conditioned than
~4e3 (as test_torch_tensorci2.py holds them: the two packages' solves and
eliminations round differently, ROADMAP C-port-1).
"""

import io
import itertools

import numpy as np
import pytest
import torch

import tci_tpu
import tci_tpu_torch
from tci_tpu.models.tensorci2 import filltensor
from tci_tpu.parallel.batcheval import VectorizedBatchEvaluator as JaxVBE

torch.set_num_threads(1)

DIMS = [6] * 5


def lorentzian_np(idx):
    v = np.asarray(idx, dtype=float) + 1.0
    return 1.0 / (1.0 + np.sum(v * v, axis=1)) + 0.1 * np.cos(v.sum(1))


def lorentzian_torch(idx):
    v = idx.to(torch.float64) + 1.0
    return 1.0 / (1.0 + (v * v).sum(1)) + 0.1 * torch.cos(v.sum(1))


def _fs():
    return (JaxVBE(lorentzian_np, DIMS),
            tci_tpu_torch.VectorizedBatchEvaluator(lorentzian_np, DIMS))


@pytest.fixture(scope="module")
def state():
    """tci_tpu's TCI2 state on DIMS at maxbonddim 3 (index sets and its
    maxsamplevalue), the state every test starts both packages from."""
    ref, _, _ = tci_tpu.crossinterpolate2(
        np.float64, JaxVBE(lorentzian_np, DIMS), DIMS, tolerance=1e-10,
        maxbonddim=3, rng=np.random.default_rng(0))
    return ref.Iset, ref.Jset


def _pair(state, f_port=None):
    """The same TCI state, site tensors filled, in both packages."""
    fj, fp = _fs()
    f_port = f_port or fp
    ref = tci_tpu.TensorCI2.from_ijsets(fj, DIMS, *state)
    out = tci_tpu_torch.TensorCI2.from_ijsets(f_port, DIMS, *state,
                                              device="cpu")
    ref.fillsitetensors(fj)
    out.fillsitetensors(f_port)
    assert out.maxsamplevalue == ref.maxsamplevalue
    _same_state(out, ref)
    return ref, out, fj, fp


def _same_state(out, ref, tensors=True):
    assert out.Iset == ref.Iset and out.Jset == ref.Jset
    assert out.linkdims() == ref.linkdims()
    if not tensors:
        return
    for site, (a, b) in enumerate(zip(out.sitetensors(), ref.sitetensors())):
        b = np.asarray(b)
        assert a.shape == b.shape
        # T = Π1 · P^{-1} after a 2-site sweep: the solves differ by up to
        # eps · cond(P) relative (test_torch_tensorci2.py), which passes
        # 1e-12 once a sweep keeps pivots near its tolerance
        cond = 1.0
        if site < len(DIMS) - 1:
            P = filltensor(np.float64, JaxVBE(lorentzian_np, DIMS), DIMS,
                           ref.Iset[site + 1], ref.Jset[site], 0)
            cond = np.linalg.cond(P.reshape(len(ref.Iset[site + 1]), -1))
        rtol = max(1e-12, np.finfo(np.float64).eps * cond)
        assert np.max(np.abs(a.numpy() - b)) <= rtol * np.max(np.abs(b))


def test_kronecker_and_existaspivot(state):
    Iset = [(0, 1), (2, 3)]
    Jset = [(4,), (5,), (1,)]
    assert tci_tpu_torch.kronecker(Iset, 3) == tci_tpu.kronecker(Iset, 3)
    assert tci_tpu_torch.kronecker(3, Jset) == tci_tpu.kronecker(3, Jset)
    ref, out, _, _ = _pair(state)
    rng = np.random.default_rng(2)
    points = [tuple(int(x) for x in rng.integers(0, 6, 5)) for _ in range(30)]
    points += [tuple(I) + (0,) + tuple(J)
               for I, J in zip(ref.Iset[2], ref.Jset[2])]
    for p in points:
        assert out.existaspivot(p) == ref.existaspivot(p)
    assert any(all(out.existaspivot(p)) for p in points) or any(
        any(out.existaspivot(p)) for p in points)


@pytest.mark.parametrize("reltol,abstol", [(1e-2, 0.0), (1e-14, 1e-3)])
def test_sweep0site_matches(state, reltol, abstol):
    ref, out, fj, fp = _pair(state)
    for b in range(len(DIMS) - 1):
        ref.sweep0site(fj, b, reltol=reltol, abstol=abstol)
        out.sweep0site(fp, b, reltol=reltol, abstol=abstol)
        _same_state(out, ref, tensors=False)
        assert out.maxsamplevalue == pytest.approx(ref.maxsamplevalue,
                                                   rel=1e-15)


@pytest.mark.parametrize("kw", [dict(reltol=1e-4), dict(maxbonddim=2),
                                dict(abstol=1e-3)])
def test_makecanonical_matches(state, kw):
    ref, out, fj, fp = _pair(state)
    ref.makecanonical(fj, **kw)
    out.makecanonical(fp, **kw)
    _same_state(out, ref)


def _found_pivots(ref, out, fj, fp, abstol):
    pj = tci_tpu.searchglobalpivots(ref, fj, abstol, nsearch=20,
                                    rng=np.random.default_rng(4))
    po = tci_tpu_torch.searchglobalpivots(out, fp, abstol, nsearch=20,
                                          rng=np.random.default_rng(4))
    assert po == pj
    return po


@pytest.mark.parametrize("maxnglobalpivot", [1, 5])
def test_searchglobalpivots_matches(state, maxnglobalpivot):
    ref, out, fj, fp = _pair(state)
    pj = tci_tpu.searchglobalpivots(ref, fj, 1e-6, nsearch=20,
                                    maxnglobalpivot=maxnglobalpivot,
                                    rng=np.random.default_rng(4))
    po = tci_tpu_torch.searchglobalpivots(out, fp, 1e-6, nsearch=20,
                                          maxnglobalpivot=maxnglobalpivot,
                                          rng=np.random.default_rng(4))
    assert po == pj and 0 < len(po) <= maxnglobalpivot
    assert tci_tpu_torch.searchglobalpivots(out, fp, 1e-6, nsearch=0) == []


def test_addglobalpivots1sitesweep_matches(state):
    ref, out, fj, fp = _pair(state)
    pivots = _found_pivots(ref, out, fj, fp, 1e-6)
    ref.addglobalpivots1sitesweep(fj, pivots, reltol=1e-6)
    out.addglobalpivots1sitesweep(fp, pivots, reltol=1e-6)
    _same_state(out, ref)


@pytest.mark.parametrize("kw", [dict(tolerance=1e-8),
                                dict(tolerance=1e-6, maxbonddim=4),
                                dict(tolerance=1e-8, strictlynested=True)])
def test_addglobalpivots2sitesweep_matches(state, kw, monkeypatch):
    ref, out, fj, fp = _pair(state)
    pivots = _found_pivots(ref, out, fj, fp, 1e-6)
    nj = ref.addglobalpivots2sitesweep(fj, pivots, **kw)
    no = out.addglobalpivots2sitesweep(fp, pivots, **kw)
    assert no == nj
    _same_state(out, ref)
    # rook (ROADMAP A9), from the same state: the host tier draws each
    # bond's start set from a new unseeded generator in both packages,
    # seeded here in call order (C-ref-4)
    ref, out, fj, fp = _pair(state)
    orig = np.random.default_rng
    left = []
    for tci, f in ((ref, fj), (out, fp)):
        draws = itertools.count(100)
        monkeypatch.setattr(np.random, "default_rng",
                            lambda seed=None: orig(next(draws) if seed is None
                                                   else seed))
        left.append(tci.addglobalpivots2sitesweep(f, pivots,
                                                  pivotsearch="rook", **kw))
    assert left[1] == left[0]
    _same_state(out, ref)


def test_engine_tier_gives_the_host_tiers_results(state):
    """The engine (a TorchBatchEvaluator: the floating-zone program for the
    search, the engine's sweeps for the insertion; makecanonical's exact
    pass outgrows its capacity and takes the host path, as tci_tpu's does)
    against the host tier (a VectorizedBatchEvaluator)."""
    bf = tci_tpu_torch.TorchBatchEvaluator(lorentzian_torch, DIMS,
                                           device="cpu")
    _, host, _, fp = _pair(state)
    _, eng, _, _ = _pair(state, f_port=bf)
    engine = bf.device_sweep_engine
    p_host = tci_tpu_torch.searchglobalpivots(host, fp, 1e-6, nsearch=20,
                                              rng=np.random.default_rng(4))
    p_eng = tci_tpu_torch.searchglobalpivots(eng, bf, 1e-6, nsearch=20,
                                             rng=np.random.default_rng(4))
    assert p_eng == p_host and len(p_eng) > 0
    assert any(key[0] == "fzone" for key in engine._sweeps)
    rank0 = eng.rank()
    assert (eng.addglobalpivots2sitesweep(bf, p_eng, tolerance=1e-8)
            == host.addglobalpivots2sitesweep(fp, p_host, tolerance=1e-8)
            == 0)
    assert eng.Iset == host.Iset and eng.Jset == host.Jset
    assert eng.rank() > rank0
    assert any("pair_full" in key for key in engine._sweeps)
    eng.makecanonical(bf, reltol=1e-6)
    host.makecanonical(fp, reltol=1e-6)
    assert eng.Iset == host.Iset and eng.Jset == host.Jset


def _lorentzian_plain(v):
    return 1.0 / (1.0 + sum((x + 1) ** 2 for x in v))


def _nesting_text(t):
    out = io.StringIO()
    t.printnestinginfo(out)
    return out.getvalue()


@pytest.mark.parametrize("dims, tol", [
    ([4] * 4, 1e-8),    # tests/test_tensorci2.py's printnestinginfo case
    ([10] * 6, 1e-6),   # a bond whose sets are not nested
])
def test_printnestinginfo_prints_tci_tpus_text(dims, tol, capsys):
    ref, _, _ = tci_tpu.crossinterpolate2(np.float64, _lorentzian_plain,
                                          dims, tolerance=tol,
                                          rng=np.random.default_rng(0))
    out, _, _ = tci_tpu_torch.crossinterpolate2(
        np.float64, _lorentzian_plain, dims, tolerance=tol,
        rng=np.random.default_rng(0), device="cpu")
    assert out.Iset == ref.Iset and out.Jset == ref.Jset
    text = _nesting_text(out)
    assert text.encode() == _nesting_text(ref).encode()
    assert ("Not nested" in text) == (dims == [10] * 6)
    # stdout by default
    out.printnestinginfo()
    ref.printnestinginfo()
    printed = capsys.readouterr().out
    assert printed == text + text
