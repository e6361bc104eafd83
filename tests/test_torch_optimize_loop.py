"""The port's sweep pair and optimize loop (tci_tpu_torch.models.device_sweep:
``sweep2site_pair``, ``optimize_loop``, ``_tt_search_on_cores``; TensorCI2's
``_optimize_device_block``; ``DefaultGlobalPivotFinder.select_device_result``)
against tci_tpu's, and against the port's per-sweep protocol, on the CPU.

Both packages sample the same integrand on the same numpy-seeded inputs.
Tolerances: ranks, index sets, set histories, sample counts and the
selected global pivots identical; errors to 3.8e-8 relative or 1e-15
absolute (normalized), the rounding of the Schur updates (ROADMAP
C-port-1); tensor trains to 1e-10 relative, the site tensors of a first
fill to 1e-12; the search on the same cores: the same first maxima, their
errors to 1e-12 relative. The port against itself (loop on, pair only, per
sweep): everything bit for bit.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tci_tpu
import tci_tpu_torch
from tci_tpu.models import device_sweep as jax_sweep
from tci_tpu.models.globalpivotfinder import (
    DefaultGlobalPivotFinder as JaxFinder)
from tci_tpu.parallel.batcheval import JaxBatchEvaluator
from tci_tpu_torch.models import device_sweep
from tci_tpu_torch.models.device_sweep import DeviceSweepEngine
from tci_tpu_torch.models.globalpivotfinder import (
    DefaultGlobalPivotFinder, GlobalPivotSearchInput)
from tci_tpu_torch.utils.device import FETCHES

torch.set_num_threads(1)

ERR_RTOL, ERR_ATOL = 3.8e-8, 1e-15


def lorentz_jax(idx):
    v = idx.astype(jnp.float64) + 1.0
    return 1.0 / (1.0 + jnp.sum(v * v))


def lorentz_torch(idx):
    v = idx.to(torch.float64) + 1.0
    return 1.0 / (1.0 + (v * v).sum(dim=1))


def _evaluators(dims, pair, loop, imax=None):
    """tci_tpu's and the port's evaluator of the Lorentzian, their engines
    set to the same protocol."""
    bj = JaxBatchEvaluator(lorentz_jax, dims)
    bt = tci_tpu_torch.TorchBatchEvaluator(lorentz_torch, dims, device="cpu")
    if imax is not None:
        bj._device_sweep_engine = jax_sweep.DeviceSweepEngine(
            lorentz_jax, dims, imax=imax)
        bt._device_sweep_engine = DeviceSweepEngine(bt._values, dims,
                                                    imax=imax, device="cpu")
    for b in (bj, bt):
        b.device_sweep_engine.use_sweep_pair = pair
        b.device_sweep_engine.use_optimize_loop = loop
    return bj, bt


def _same_sets(out, ref):
    assert out.Iset == ref.Iset and out.Jset == ref.Jset
    assert out.Iset_history == ref.Iset_history
    assert out.Jset_history == ref.Jset_history


def _same_trajectory(out, oranks, oerrs, ref, rranks, rerrs):
    """Two crossinterpolate2 results; their tensor trains to rtol 1e-10, as
    in tests/test_torch_device_sweep.py (the site tensors themselves divide
    by pivots down to the tolerance, where the packages' rounding grows)."""
    assert oranks == rranks
    np.testing.assert_allclose(oerrs, rerrs, rtol=ERR_RTOL, atol=ERR_ATOL)
    _same_sets(out, ref)
    _same_tensor_train(out, ref)


def _same_tensor_train(out, ref):
    pts = np.asarray(list(itertools.product(*map(range, out.localdims))))
    np.testing.assert_allclose(
        tci_tpu_torch.TensorTrain(out.sitetensors()).evaluate_batch(
            pts).numpy().reshape(out.localdims),
        tci_tpu.fulltensor(tci_tpu.tensortrain(ref)), rtol=1e-10, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_device_result_matches_tci_tpu(seed):
    """Seeded search outputs, with ties among the errors and more passing
    starts than the cap: the same pivot lists."""
    rng = np.random.default_rng(seed)
    dims = [4, 3, 5, 4]
    S, dmax = 8, max(dims)
    starts = [tuple(int(rng.integers(0, d)) for d in dims) for _ in range(S)]
    legs = rng.integers(0, len(dims), S)
    best_flat = np.asarray([p * dmax + rng.integers(0, dims[p])
                            for p in legs])
    best_err = rng.choice([1e-9, 1e-7, 1e-7, 3e-6], S)
    for cap, abstol in ((5, 1e-9), (8, 1e-8), (2, 0.0)):
        ref = JaxFinder(nsearch=S, maxnglobalpivot=cap).select_device_result(
            starts, best_flat.astype(np.int32), best_err, dmax, abstol)
        out = DefaultGlobalPivotFinder(
            nsearch=S, maxnglobalpivot=cap).select_device_result(
            starts, best_flat, best_err, dmax, abstol)
        assert out == ref
        assert len(out) <= cap


def test_search_on_cores_matches_tci_tpu():
    """tci_tpu's non-uniform case ([4, 3, 5, 4]: clamped values, masked
    duplicates): the padded cores of one tci_tpu fill (of a converged
    TCI's sets), its lengths and six start points through both
    searches."""
    dims = [4, 3, 5, 4]
    bt = tci_tpu_torch.TorchBatchEvaluator(lorentz_torch, dims, device="cpu")
    t, _, _ = tci_tpu_torch.crossinterpolate2(
        np.float64, bt, dims, tolerance=1e-8, device="cpu",
        rng=np.random.default_rng(0))
    ej = jax_sweep.DeviceSweepEngine(lorentz_jax, dims,
                                     imax=bt.device_sweep_engine.Imax)
    Iset, Ilen = ej._pack(t.Iset, "left")
    Jset, Jlen = ej._pack(t.Jset, "left")
    cores, _ = ej._get_fill()(jnp.asarray(Iset), jnp.asarray(Ilen),
                              jnp.asarray(Jset), jnp.asarray(Jlen))
    starts = np.asarray(JaxFinder(nsearch=6).draw_starts(
        dims, np.random.default_rng(11)), dtype=np.int32)
    rflat, rerr = jax_sweep._tt_search_on_cores(
        lorentz_jax, dims, ej.Imax, jnp.float64, False, cores, None,
        jnp.asarray(Ilen), jnp.asarray(Jlen), jnp.asarray(starts))

    oflat, oerr = device_sweep._tt_search_on_cores(
        lorentz_torch, torch.float64, bt.device_sweep_engine._layout(),
        torch.from_numpy(np.array(cores)),
        torch.from_numpy(Ilen.astype(np.int64)),
        torch.from_numpy(Jlen.astype(np.int64)),
        torch.from_numpy(starts.astype(np.int64)))
    assert oflat.tolist() == np.asarray(rflat).tolist()
    np.testing.assert_allclose(oerr.numpy(), np.asarray(rerr), rtol=1e-12,
                               atol=0)
    assert np.isfinite(oerr.numpy()).all()


def test_search_in_the_pair_matches_the_host_finder():
    """The port's search in the pair program and its host finder, from the
    same start points against the same tensor train, one far from
    converged, at abstol 1e-16 (every start's best candidate passes): the
    same pivots."""
    dims = [4, 3, 5, 4]
    bt = tci_tpu_torch.TorchBatchEvaluator(lorentz_torch, dims, device="cpu")
    t, _, _ = tci_tpu_torch.crossinterpolate2(
        np.float64, bt, dims, tolerance=1e-3, maxiter=1, device="cpu",
        rng=np.random.default_rng(0))
    finder = DefaultGlobalPivotFinder(nsearch=6, maxnglobalpivot=6)
    starts = finder.draw_starts(dims, np.random.default_rng(11))
    empty = [[] for _ in dims]
    engine = bt.device_sweep_engine
    assert engine.sweep2site_pair(t, True, False, 1e-14, 1e-3, 2**62, empty,
                                  empty, search_starts=starts)
    best_flat, best_err = engine.last_search
    assert best_err.min() > 1e-9
    dev = finder.select_device_result(starts, best_flat, best_err, max(dims),
                                      1e-16)
    host = finder(GlobalPivotSearchInput.from_tci(t), bt, 1e-16,
                  initial_points=starts)
    assert dev == host and len(dev) == 6


@pytest.mark.parametrize("strictlynested", [False, True])
def test_sweep2site_pair_calls_match_tci_tpu(strictlynested):
    """Three sweep2site calls of two sweeps each from the same two pivots,
    each one pair with its search, in both packages; after each: the sets,
    their history, the pivot errors, the tensor train, the pivots the
    search selects and the sample count. The site tensors of the first
    fill to 1e-12; later fills divide by pivots down to the abstol (2e-13
    at the last), where the rounding of the two packages' solves grows."""
    dims = [4] * 5
    bj, bt = _evaluators(dims, pair=True, loop=False)
    pivots = [tuple(int(v) for v in p) for p in
              np.random.default_rng(2).integers(0, 4, size=(2, 5))]
    ref = tci_tpu.TensorCI2.from_function(bj, dims, pivots)
    out = tci_tpu_torch.TensorCI2.from_function(bt, dims, pivots,
                                                device="cpu")
    rng = np.random.default_rng(5)
    finder = DefaultGlobalPivotFinder()
    for abstol in (1e-4, 1e-8, 1e-12):
        starts = finder.draw_starts(dims, rng)
        for tci, f in ((ref, bj), (out, bt)):
            tci.sweep2site(f, 2, abstol=abstol, strictlynested=strictlynested,
                           _search_starts=starts)
        _same_sets(out, ref)
        np.testing.assert_allclose(out.pivoterrors, ref.pivoterrors,
                                   rtol=ERR_RTOL, atol=ERR_ATOL)
        if abstol == 1e-4:
            for a, b in zip(out.sitetensors(), ref.sitetensors()):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                           atol=1e-12)
        _same_tensor_train(out, ref)
        # the search: the same errors, and the same selected pivots (the
        # first maximum itself may differ where two candidates tie, as
        # permuted points of this symmetric f do)
        (oflat, oerr), (rflat, rerr) = out._pair_search, ref._pair_search
        np.testing.assert_allclose(oerr, np.asarray(rerr), rtol=1e-6,
                                   atol=1e-12)
        assert finder.select_device_result(
            starts, oflat, oerr, 4, abstol) == finder.select_device_result(
            starts, np.asarray(rflat), np.asarray(rerr), 4, abstol)
        assert bt.nevals == bj.nevals
    assert bt.device_sweep_engine.last_sweep_filled


def test_pair_reads_the_input_sets_as_second_extras():
    """The second sweep of a pair takes the pair's input sets as extras,
    not the first sweep's output (``_sweep`` updates its sets in place).
    From six pivots, at an abstol that makes the first sweep drop most of
    them, two sweep2site calls through the pair equal the same calls
    through two per-sweep programs, bit for bit."""
    dims = [4] * 5
    w = torch.tensor([1.0, 0.7, 0.4, 0.3, 0.2], dtype=torch.float64)

    def f(idx):
        return 1.0 / (1.0 + ((idx.to(torch.float64) + 1.0) * w).sum(1) ** 2)

    pivots = [tuple(int(v) for v in p) for p in
              np.random.default_rng(1).integers(0, 4, size=(6, 5))]

    def run(pair):
        bt = tci_tpu_torch.TorchBatchEvaluator(f, dims, device="cpu")
        bt.device_sweep_engine.use_sweep_pair = pair
        tci = tci_tpu_torch.TensorCI2.from_function(bt, dims, pivots,
                                                    device="cpu")
        states = []
        for _ in range(2):
            tci.sweep2site(bt, 2, abstol=1e-4, maxbonddim=4)
            states.append((tci.Iset, tci.Jset, list(tci.pivoterrors),
                           list(tci.bonderrors)))
        return tci, states

    (pt, pstates), (st, sstates) = run(True), run(False)
    assert pstates == sstates
    assert pt.Iset_history == st.Iset_history
    assert pt.Jset_history == st.Jset_history
    for a, b in zip(pt.sitetensors(), st.sitetensors()):
        assert torch.equal(a, b)


def test_sweep_pair_capacity_growth():
    """tests/test_device_sweep.py::test_sweep_pair_capacity_growth: the
    pair from a capacity of 2 grows, and gives tci_tpu's result."""
    dims = [4] * 4
    bj, bt = _evaluators(dims, pair=True, loop=False, imax=2)
    ref, rranks, rerrs = tci_tpu.crossinterpolate2(
        np.float64, bj, dims, tolerance=1e-12, rng=np.random.default_rng(0))
    out, oranks, oerrs = tci_tpu_torch.crossinterpolate2(
        np.float64, bt, dims, tolerance=1e-12, rng=np.random.default_rng(0),
        device="cpu")
    _same_trajectory(out, oranks, oerrs, ref, rranks, rerrs)
    assert bt.nevals == bj.nevals
    assert bt.device_sweep_engine.Imax == bj.device_sweep_engine.Imax > 2


def _counting(monkeypatch):
    """Count the calls of both packages' sweep2site_pair and optimize_loop."""
    calls = {}
    for pkg, cls in (("jax", jax_sweep.DeviceSweepEngine),
                     ("torch", DeviceSweepEngine)):
        for name in ("sweep2site_pair", "optimize_loop"):
            fn = getattr(cls, name)

            def counted(self, *a, _fn=fn, _key=(pkg, name), **k):
                calls[_key] = calls.get(_key, 0) + 1
                return _fn(self, *a, **k)
            monkeypatch.setattr(cls, name, counted)
    return calls


@pytest.mark.parametrize("strictlynested", [False, True])
def test_optimize_loop_matches_tci_tpu(strictlynested, monkeypatch):
    """crossinterpolate2 at both packages' defaults (pair and loop on) on
    [4]^5: the same trajectory, sample count and number of loop blocks; no
    iteration leaves the loop."""
    dims = [4] * 5
    bj, bt = _evaluators(dims, pair=True, loop=True)
    calls = _counting(monkeypatch)
    kw = {"tolerance": 1e-10, "strictlynested": strictlynested}
    ref, rranks, rerrs = tci_tpu.crossinterpolate2(
        np.float64, bj, dims, rng=np.random.default_rng(21), **kw)
    fetches, status = FETCHES["engine"], FETCHES["engine_status"]
    out, oranks, oerrs = tci_tpu_torch.crossinterpolate2(
        np.float64, bt, dims, rng=np.random.default_rng(21), device="cpu",
        **kw)
    _same_trajectory(out, oranks, oerrs, ref, rranks, rerrs)
    assert bt.nevals == bj.nevals
    assert calls[("torch", "optimize_loop")] == calls[("jax", "optimize_loop")]
    assert ("torch", "sweep2site_pair") not in calls
    assert ("jax", "sweep2site_pair") not in calls
    engine = bt.device_sweep_engine
    # one block: a status read an iteration, one fetch for the block and
    # one for the final 1-site sweep
    assert engine.loop_blocks == 1 and engine.loop_steps == len(oranks)
    assert FETCHES["engine_status"] - status == len(oranks)
    assert FETCHES["engine"] - fetches == 2
    # every iteration ran in the loop: its wall is its step's, and the
    # loop path has no sweep or search wall apart
    assert all(np.isnan(out.stats[key]).all() and len(out.stats[key])
               == len(oranks)
               for key in ("sweep_walltime", "globalsearch_walltime"))
    assert all(w > 0 for w in out.stats["iteration_walltime"])


def test_optimize_loop_growth_matches_tci_tpu():
    """tests/test_device_sweep.py::test_optimize_loop_capacity_growth: the
    loop from a capacity of 2 saturates (code 2), the host grows it and
    enters again from the state before the discarded iteration."""
    dims = [4] * 4
    bj, bt = _evaluators(dims, pair=True, loop=True, imax=2)
    ref, rranks, rerrs = tci_tpu.crossinterpolate2(
        np.float64, bj, dims, tolerance=1e-12, rng=np.random.default_rng(3))
    out, oranks, oerrs = tci_tpu_torch.crossinterpolate2(
        np.float64, bt, dims, tolerance=1e-12, rng=np.random.default_rng(3),
        device="cpu")
    _same_trajectory(out, oranks, oerrs, ref, rranks, rerrs)
    assert bt.nevals == bj.nevals
    engine = bt.device_sweep_engine
    assert engine.Imax == bj.device_sweep_engine.Imax > 2
    assert engine.loop_blocks > 1


def _oscillating(n):
    """tests/test_device_sweep.py::test_optimize_loop_global_pivot_exit's
    quantics integrand, on which the search fires."""
    w = torch.from_numpy(2.0 ** -(np.arange(1, n + 1, dtype=np.float64)))

    def f(bits):
        x = (bits.to(torch.float64) * w).sum(dim=1)
        return torch.exp(-10 * x) * torch.sin(2 * np.pi * 100 * x ** 1.1)

    def fpy(bits):
        return float(f(torch.tensor([bits]))[0])

    dims = [2] * n
    return f, dims, [tuple(tci_tpu_torch.optfirstpivot(fpy, dims, [1] * n))]


# case: (integrand, dims, initial pivots, crossinterpolate2 arguments,
# engine settings)
SELF_CASES = {
    "global_pivot_exit": (*_oscillating(10), {
        "tolerance": 1e-12, "maxbonddim": 100, "maxiter": 100,
        "nsearchglobalpivot": 10}, {}),
    "maxiter_below_kmax": (lorentz_torch, [4] * 5, None,
                           {"tolerance": 1e-10, "maxiter": 2}, {}),
    "blocks_of_two": (lorentz_torch, [4] * 5, None, {"tolerance": 1e-12},
                      {"loop_kmax": 2}),
    "verbosity": (lorentz_torch, [4] * 5, None,
                  {"tolerance": 1e-10, "verbosity": 1}, {}),
    # no start points: the loop and the pair without the search
    "no_search": (lorentz_torch, [4] * 5, None,
                  {"tolerance": 1e-10, "nsearchglobalpivot": 0}, {}),
    # capped at 2, the loop, the pair and the per-sweep engine all decline
    # and the per-bond fused tier runs
    "decline": (lorentz_torch, [4] * 4, None, {"tolerance": 1e-12},
                {"Imax": 2, "imax_cap": 2}),
}


@pytest.mark.parametrize("case", list(SELF_CASES))
def test_loop_pair_and_per_sweep_agree_bitwise(case):
    """The port against itself: loop on, pair only, per sweep; ranks, error
    series, sets, histories, site tensors, samples and pivot counts bit for
    bit."""
    f, dims, pivots, kw, settings = SELF_CASES[case]
    runs = []
    for pair, loop in ((True, True), (True, False), (False, False)):
        bt = tci_tpu_torch.TorchBatchEvaluator(f, dims, device="cpu")
        engine = bt.device_sweep_engine
        engine.use_sweep_pair, engine.use_optimize_loop = pair, loop
        for name, value in settings.items():
            setattr(engine, name, value)
        t, ranks, errs = tci_tpu_torch.crossinterpolate2(
            np.float64, bt, dims, pivots, device="cpu",
            rng=np.random.default_rng(1234), **kw)
        runs.append((t, ranks, errs, bt.nevals, engine))
    t0, ranks0, errs0, nevals0, engine0 = runs[0]
    for t, ranks, errs, nevals, _ in runs[1:]:
        assert ranks == ranks0 and errs == errs0 and nevals == nevals0
        assert t.Iset == t0.Iset and t.Jset == t0.Jset
        assert t.Iset_history == t0.Iset_history
        assert t.Jset_history == t0.Jset_history
        assert t.stats["nglobalpivots"] == t0.stats["nglobalpivots"]
        for a, b in zip(t.sitetensors(), t0.sitetensors()):
            assert torch.equal(a, b)
    if case == "global_pivot_exit":
        assert sum(t0.stats["nglobalpivots"]) > 0
        assert engine0.loop_blocks > 1
        assert errs0[-1] < 1e-10
    if case == "maxiter_below_kmax":
        assert len(ranks0) == 2 and engine0.loop_steps == 2
    if case == "blocks_of_two":
        assert engine0.loop_blocks == (len(ranks0) + 1) // 2
    if case == "verbosity":
        # verbosity > 0 takes the per-iteration path, as in tci_tpu
        assert engine0.loop_blocks == 0
    elif case == "decline":
        # every attempt of the engine saturated and was discarded
        assert engine0.nevals == 0 and engine0.Imax == 2
    else:
        assert engine0.loop_blocks > 0
