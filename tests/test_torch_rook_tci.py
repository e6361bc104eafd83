"""TCI2 with ``pivotsearch="rook"`` on each of the port's tiers against
tci_tpu's same tier, on the CPU: the whole-sweep engine under the per-sweep
protocol, the sweep pair and the optimize loop (tci_tpu's default); the
per-bond device tier (``enable_device_sweep=False``: the panel sampler and
``rrlu_serving``); the host tier (a plain f: ``arrlu`` on a
``SubMatrix``); ``addglobalpivots2sitesweep``; and the pins of C-ref-1 to
C-ref-3 on the per-bond tier.

Both packages get the same f, the same ``rng`` seed and, for the engine,
the same seed generator (``engine._rng``). The host tier draws each bond's
start set from a new unseeded ``np.random.default_rng()`` in both
packages, so the tests seed those draws in order (``_seeded_default_rng``).
Tolerances: ranks, index sets and sample counts identical; the normalized
errors within 1e-15 (C-port-1); the tensor trains within 1e-10 relative.
"""

import itertools
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tci_tpu
import tci_tpu_torch
from tci_tpu.models.device_sweep import DeviceSweepEngine as JaxEngine
from tci_tpu.parallel.batcheval import JaxBatchEvaluator
from tci_tpu_torch.models.device_sweep import DeviceSweepEngine

torch.set_num_threads(1)

ERR_ATOL = 1e-15
W = np.array([1.0, 1.3, 0.7, 1.9, 1.1])


def lorentz_jax(idx):
    v = idx.astype(jnp.float64) + 1.0
    return 1.0 / (1.0 + jnp.sum(v * v))


def lorentz_torch(idx):
    v = idx.to(torch.float64) + 1.0
    return 1.0 / (1.0 + (v * v).sum(dim=1))


def weighted_py(x):
    """An f without the symmetry of the Lorentzian under permuted legs, so
    that no exact tie decides a pivot (ROADMAP C-port-8, C-port-13)."""
    v = np.asarray(x, dtype=float) + 1.0
    return 1.0 / (1.0 + float(np.sum(W[:len(v)] * v * v)))


def _full(tci, dims):
    pts = np.asarray(list(itertools.product(*map(range, dims))))
    return tci_tpu_torch.TensorTrain(tci.sitetensors()).evaluate_batch(
        pts).numpy().reshape(dims)


def _seeded_default_rng(monkeypatch):
    """From the call of the returned reseed() on, np.random.default_rng()
    without a seed returns generators seeded 100, 101, ... in call order
    (each package's host rook tier makes one a bond); reseed() before each
    package's run. Also returns numpy's own default_rng."""
    orig = np.random.default_rng
    count = [itertools.count(100)]

    def reseed():
        count[0] = itertools.count(100)

    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: orig(next(count[0]) if seed is None
                                               else seed))
    return orig, reseed


def _same_run(ref, rranks, rerrs, out, oranks, oerrs, dims):
    assert oranks == rranks
    assert out.Iset == ref.Iset and out.Jset == ref.Jset
    np.testing.assert_allclose(oerrs, rerrs, rtol=0, atol=ERR_ATOL)
    np.testing.assert_allclose(
        _full(out, dims), tci_tpu.fulltensor(tci_tpu.tensortrain(ref)),
        rtol=1e-10, atol=0)


# protocol: (use_sweep_pair, use_optimize_loop)
PROTOCOLS = {"per_sweep": (False, False), "pair": (True, False),
             "loop": (True, True)}


@pytest.mark.parametrize("protocol", list(PROTOCOLS))
def test_engine_rook_matches_tci_tpu(protocol):
    """The whole-sweep rook: per bond the start set widened by threefry
    priorities (the port's copy of jax.random) and the predicated slab
    alternation; the pair and the loop draw their seeds as tci_tpu's do."""
    dims = [4] * 5
    pair, loop = PROTOCOLS[protocol]
    bj = JaxBatchEvaluator(lorentz_jax, dims)
    bt = tci_tpu_torch.TorchBatchEvaluator(lorentz_torch, dims, device="cpu")
    for b in (bj, bt):
        eng = b.device_sweep_engine
        eng._rng = np.random.default_rng(7)
        eng.use_sweep_pair, eng.use_optimize_loop = pair, loop
    kw = dict(tolerance=1e-10, pivotsearch="rook", maxiter=6)
    ref, rranks, rerrs = tci_tpu.crossinterpolate2(
        np.float64, bj, dims, rng=np.random.default_rng(5), **kw)
    out, oranks, oerrs = tci_tpu_torch.crossinterpolate2(
        np.float64, bt, dims, rng=np.random.default_rng(5), device="cpu",
        **kw)
    _same_run(ref, rranks, rerrs, out, oranks, oerrs, dims)
    assert bt.nevals == bj.nevals
    engine = bt.device_sweep_engine
    assert bt._fused_updater is None and bt._panel_sampler is None
    kinds = {k[-1] if isinstance(k[-1], str) else k[3] for k in
             engine._sweeps if k[0] != "sweep1"}
    expect = {"per_sweep": {"rook", "fused_rook"}, "pair": {"pair_rook"},
              "loop": {"rook"}}[protocol]
    assert kinds == expect
    # every rook bond launches its five predicated slab steps
    L = len(dims)
    for key, p in engine._sweeps.items():
        if "rook" in key or "pair_rook" in key:
            sweeps = 1 if key[2] in ("rook", "fused_rook") else 2
            fill = int(key[2] != "rook")
            assert p.rrlu_launches == sweeps * (L - 1) * 5 + fill


def test_engine_rook_growth_and_nonuniform():
    """The rook engine from a capacity of 2 on non-uniform local dimensions
    (padding slots at every bond): it grows as tci_tpu's does."""
    dims = [2, 5, 3, 4, 2]
    bj = JaxBatchEvaluator(lorentz_jax, dims)
    bj._device_sweep_engine = JaxEngine(lorentz_jax, dims, imax=2)
    bt = tci_tpu_torch.TorchBatchEvaluator(lorentz_torch, dims, device="cpu")
    bt._device_sweep_engine = DeviceSweepEngine(bt._values, dims, imax=2,
                                                device="cpu")
    for b in (bj, bt):
        b.device_sweep_engine._rng = np.random.default_rng(3)
    kw = dict(tolerance=1e-10, pivotsearch="rook", maxiter=5)
    ref, rranks, rerrs = tci_tpu.crossinterpolate2(
        np.float64, bj, dims, rng=np.random.default_rng(1), **kw)
    out, oranks, oerrs = tci_tpu_torch.crossinterpolate2(
        np.float64, bt, dims, rng=np.random.default_rng(1), device="cpu",
        **kw)
    _same_run(ref, rranks, rerrs, out, oranks, oerrs, dims)
    assert bt.nevals == bj.nevals
    assert bt.device_sweep_engine.Imax == bj.device_sweep_engine.Imax > 2


def test_per_bond_device_rook_matches_tci_tpu():
    """enable_device_sweep=False: every bond's Π panel from the panel
    sampler, then rrlu_serving with the mixed f32 hunt and, at sweep2site's
    reltol 1e-14, two hunt stages (C-ref-1); tci_tpu's RuntimeWarning."""
    dims = [4] * 5
    bj = JaxBatchEvaluator(lorentz_jax, dims, enable_device_sweep=False)
    bt = tci_tpu_torch.TorchBatchEvaluator(lorentz_torch, dims, device="cpu",
                                           enable_device_sweep=False)
    kw = dict(tolerance=1e-10, pivotsearch="rook", maxiter=4)
    with pytest.warns(RuntimeWarning, match="per-bond rook tier"):
        ref, rranks, rerrs = tci_tpu.crossinterpolate2(
            np.float64, bj, dims, rng=np.random.default_rng(5), **kw)
    with pytest.warns(RuntimeWarning, match="per-bond rook tier"):
        out, oranks, oerrs = tci_tpu_torch.crossinterpolate2(
            np.float64, bt, dims, rng=np.random.default_rng(5), device="cpu",
            **kw)
    _same_run(ref, rranks, rerrs, out, oranks, oerrs, dims)
    assert bt.nevals == bj.nevals
    assert bt.panel_sampler.nevals == bj.panel_sampler.nevals > 0


def test_host_rook_matches_tci_tpu(monkeypatch):
    """A plain f: arrlu on a SubMatrix each bond, each slab factorized on
    the TCI's device."""
    dims = [4] * 5
    orig, reseed = _seeded_default_rng(monkeypatch)
    kw = dict(tolerance=1e-10, pivotsearch="rook", maxiter=4)
    reseed()
    ref, rranks, rerrs = tci_tpu.crossinterpolate2(
        np.float64, weighted_py, dims, rng=orig(5), **kw)
    reseed()
    out, oranks, oerrs = tci_tpu_torch.crossinterpolate2(
        np.float64, weighted_py, dims, rng=orig(5), device="cpu", **kw)
    _same_run(ref, rranks, rerrs, out, oranks, oerrs, dims)


def test_host_rook_symmetric_f_parts_at_ties_c_port_13(monkeypatch):
    """C-port-13, pinned. On the Lorentzian, symmetric under permuted legs,
    the host rook tier's sweeps agree set for set, but the global pivots
    found after the first iteration do not (the same number of them): the
    search meets exact ties, which the two packages' rounding of the
    interpolation breaks apart (C-port-8's mechanism). The later ranks, the
    converged sets and the errors agree; the first iteration's rank need
    not."""
    dims = [4] * 5
    fpy = lambda x: 1.0 / (1.0 + float(np.sum((np.asarray(x) + 1.0) ** 2)))
    orig, reseed = _seeded_default_rng(monkeypatch)
    kw = dict(tolerance=1e-10, pivotsearch="rook", maxiter=6)
    reseed()
    ref, rranks, rerrs = tci_tpu.crossinterpolate2(
        np.float64, fpy, dims, rng=orig(5), **kw)
    reseed()
    out, oranks, oerrs = tci_tpu_torch.crossinterpolate2(
        np.float64, fpy, dims, rng=orig(5), device="cpu", **kw)
    assert out.stats["nglobalpivots"] == ref.stats["nglobalpivots"]
    assert oranks[1:] == rranks[1:]
    assert out.Iset == ref.Iset and out.Jset == ref.Jset
    np.testing.assert_allclose(oerrs, rerrs, rtol=0, atol=ERR_ATOL)


@pytest.mark.parametrize("tier", ["engine", "host"])
def test_addglobalpivots2sitesweep_rook(monkeypatch, tier):
    """Rook sweeps until the given pivots are interpolated, on the engine
    and on the host tier: the same pivots left (none) and the same grown
    index sets as tci_tpu."""
    dims = [4] * 5
    orig, reseed = _seeded_default_rng(monkeypatch)
    pivots = [(3, 0, 2, 1, 3), (1, 3, 3, 0, 2)]
    if tier == "engine":
        fj = JaxBatchEvaluator(lorentz_jax, dims)
        ft = tci_tpu_torch.TorchBatchEvaluator(lorentz_torch, dims,
                                               device="cpu")
        for b in (fj, ft):
            b.device_sweep_engine._rng = orig(11)
    else:
        fj = ft = weighted_py
    ref = tci_tpu.TensorCI2.from_function(fj, dims)
    out = tci_tpu_torch.TensorCI2.from_function(ft, dims, device="cpu")
    left = []
    for tci, f in ((ref, fj), (out, ft)):
        reseed()
        tci.optimize(f, tolerance=1e-8, maxbonddim=3, pivotsearch="rook",
                     rng=orig(2), maxiter=3)
        left.append(tci.addglobalpivots2sitesweep(
            f, pivots, tolerance=1e-10, pivotsearch="rook"))
    assert left[0] == left[1] == 0
    assert out.Iset == ref.Iset and out.Jset == ref.Jset


class _StubSampler:
    """A panel sampler that hands out a fixed panel and max |sample|."""

    def __init__(self, panel, maxsample):
        self.panel, self.maxsample = panel, maxsample

    def sample(self, Icombined, Jcombined):
        return self.panel, self.maxsample


class _StubEvaluator:
    def __init__(self, sampler):
        self.panel_sampler = sampler


@pytest.mark.parametrize("maxsample,reltol,stages", [
    (1.0, 1e-14, 2),          # C-ref-1: the default reltol is always deep
    (1.0, 1e-5, 2),           # abstol 1e-9 < 1e-6 max|sample|: deep
    (float("nan"), 1e-5, 1),  # C-ref-2: a NaN max|sample| skips the deep hunt
])
def test_c_ref_1_2_deep_hunt_rule(monkeypatch, rng, maxsample, reltol,
                                  stages):
    """C-ref-1 and C-ref-2, pinned on the per-bond device tier: the stages
    both packages ask rrlu_serving for, from the same panel."""
    from tci_tpu.ops import lu_device as jd
    from tci_tpu_torch.ops import lu_device as td

    dims = [4] * 4
    A = rng.standard_normal((16, 16))
    seen = {}
    for name, mod in (("tci_tpu", jd), ("port", td)):
        def spy(*args, _name=name, **kw):
            seen[_name] = kw["hunt_stages"]
            raise StopIteration

        monkeypatch.setattr(mod, "rrlu_rook_device_fused", spy)
    for name, pkg, panel in (("tci_tpu", tci_tpu, jnp.asarray(A)),
                             ("port", tci_tpu_torch, torch.from_numpy(A))):
        kw = {} if pkg is tci_tpu else {"device": "cpu"}
        tci = pkg.TensorCI2(dims, **kw)
        tci.addglobalpivots([(i, i, i, i) for i in range(4)])
        f = _StubEvaluator(_StubSampler(panel, maxsample))
        with pytest.raises(StopIteration):
            tci.updatepivots(1, f, True, reltol=reltol, abstol=1e-9,
                             pivotsearch="rook")
    assert seen == {"tci_tpu": stages, "port": stages}


def test_c_ref_3_widen_and_retry(rng):
    """C-ref-3, the test the reference lacks: a bond whose Π panel (36 x 36,
    full rank) has a rank above max(16, 2 |I0|) = 16, so the per-bond
    device tier's slab width is rank-capped at 16, widened to 32, then to
    the cap 36, warm-started from the pivots found; the same widths, pivot
    sets and errors as tci_tpu."""
    from tci_tpu.ops import lu_device as jd
    from tci_tpu_torch.ops import lu_device as td

    dims = [6] * 4
    M = rng.standard_normal((6,) * 4)

    def fj(idx):
        return jnp.asarray(M)[idx[0], idx[1], idx[2], idx[3]]

    Mt = torch.from_numpy(M)

    def ft(idx):
        return Mt[idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]]

    widths = {"tci_tpu": [], "port": []}
    results = {}
    for name, pkg, mod, f in (
            ("tci_tpu", tci_tpu, jd,
             JaxBatchEvaluator(fj, dims, enable_device_sweep=False)),
            ("port", tci_tpu_torch, td, tci_tpu_torch.TorchBatchEvaluator(
                ft, dims, device="cpu", enable_device_sweep=False))):
        orig = mod.rrlu_rook_device_fused

        def spy(*args, _orig=orig, _name=name, **kw):
            widths[_name].append(kw["maxrank"])
            return _orig(*args, **kw)

        mod.rrlu_rook_device_fused = spy
        try:
            kw = {} if pkg is tci_tpu else {"device": "cpu"}
            tci = pkg.TensorCI2(dims, **kw)
            tci.addglobalpivots([(i, i, i, i) for i in range(6)])
            tci.rng = np.random.default_rng(4)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                tci.updatepivots(1, f, True, reltol=1e-14, abstol=0.0,
                                 pivotsearch="rook")
        finally:
            mod.rrlu_rook_device_fused = orig
        results[name] = (tci.Iset[2], tci.Jset[1], tci.pivoterrors)
    assert widths["tci_tpu"] == widths["port"] == [16, 32, 36]
    assert results["port"][:2] == results["tci_tpu"][:2]
    assert len(results["port"][0]) == 36
    np.testing.assert_allclose(results["port"][2], results["tci_tpu"][2],
                               rtol=1e-10, atol=1e-15)
