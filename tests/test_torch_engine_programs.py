"""The program holder of the port's whole-sweep engine
(tci_tpu_torch.models.device_sweep: ``_Program`` and the engine's
``_sweeps``), on the CPU.

On a CUDA device the engine records each body into a CUDA graph and replays
it; here the same holder runs the bodies eagerly ("eager"), or through a
stand-in for a graph ("replayed": ``emulate_graphs``) that does to the
holder what a graph does: its capture leaves the device state as it was,
and its replay writes the results into the same output tensors every time.

Every run is held against tci_tpu's engine on the same numpy-seeded inputs.
Tolerances: pivot sets and ranks identical; pivot errors to 1e-15 absolute,
the rounding of the Schur updates (tests/test_torch_tensorci2.py); integrals
of two calls on one evaluator equal bit for bit.
"""

import gc
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tci_tpu
import tci_tpu_torch
from tci_tpu.models.device_sweep import DeviceSweepEngine as JaxEngine
from tci_tpu.parallel.batcheval import JaxBatchEvaluator
from tci_tpu_torch.models import integration
from tci_tpu_torch.models.device_sweep import DeviceSweepEngine
from tci_tpu_torch.ops import lu_cuda

torch.set_num_threads(1)

ERR_ATOL = 1e-15


def _lorentz(dims):
    def fj(idx):
        v = idx.astype(jnp.float64) + 1.0
        return 1.0 / (1.0 + jnp.sum(v * v))

    def ft(idx):
        v = idx.to(torch.float64) + 1.0
        return 1.0 / (1.0 + (v * v).sum(dim=1))

    return fj, ft


def _quantics(R):
    """1 / (1 + 25 x^2) on a 2^R grid: x is a sum of distinct powers of two,
    so both packages sample the same bits."""
    w = np.asarray([2.0 ** -(r + 1) for r in range(R)])
    wj, wt = jnp.asarray(w), torch.from_numpy(w)

    def fj(bits):
        x = jnp.sum(bits.astype(jnp.float64) * wj)
        return 1.0 / (1.0 + 25.0 * x * x)

    def ft(bits):
        x = (bits.to(torch.float64) * wt).sum(dim=1)
        return 1.0 / (1.0 + 25.0 * x * x)

    return fj, ft


PROBLEMS = {
    "4^5": ([4] * 5, _lorentz),
    "6^4": ([6] * 4, _lorentz),
    "R8": ([2] * 8, lambda dims: _quantics(len(dims))),
}


def emulate_graphs(engine):
    """Make a CPU engine hold its programs as a CUDA engine holds graphs.
    The "capture" runs the body once and puts the input records back (a
    capture runs nothing on the device); the "replay" runs it again and
    copies the results into the tensors the capture returned, which is all
    a replay's caller ever sees."""
    def capture(body):
        saved = [(p, p._record.clone()) for p in engine._sweeps.values()]
        out = body()
        for p, record in saved:
            p._record.copy_(record)

        def replay():
            for o, new in zip(out, body()):
                if isinstance(o, torch.Tensor):
                    o.copy_(new)

        return replay, out

    engine.cuda_graphs = True
    engine._capture = capture
    return engine


def _pair(problem, mode, imax=None):
    """tci_tpu's and the port's evaluator for one problem, their engines
    set to the same per-sweep protocol (tests/test_torch_optimize_loop.py
    holds the default one)."""
    dims, make = PROBLEMS[problem]
    fj, ft = make(dims)
    bj = JaxBatchEvaluator(fj, dims)
    bt = tci_tpu_torch.TorchBatchEvaluator(ft, dims, device="cpu")
    if imax is not None:
        bj._device_sweep_engine = JaxEngine(fj, dims, imax=imax)
        bt._device_sweep_engine = DeviceSweepEngine(bt._values, dims,
                                                    imax=imax, device="cpu")
    for b in (bj, bt):
        b.device_sweep_engine.use_sweep_pair = False
        b.device_sweep_engine.use_optimize_loop = False
    assert bt.device_sweep_engine.cuda_graphs is False  # a CPU engine
    if mode == "replayed":
        emulate_graphs(bt.device_sweep_engine)
    return dims, bj, bt


def _start(dims, bj, bt):
    pivots = [tuple(int(v) for v in p) for p in
              np.random.default_rng(2).integers(0, min(dims),
                                                size=(2, len(dims)))]
    ref = tci_tpu.TensorCI2.from_function(bj, dims, pivots)
    out = tci_tpu_torch.TensorCI2.from_function(bt, dims, pivots,
                                                device="cpu")
    return ref, out


def _same_state(out, ref):
    assert out.Iset == ref.Iset and out.Jset == ref.Jset
    assert len(out.pivoterrors) == len(ref.pivoterrors)
    np.testing.assert_allclose(out.pivoterrors, ref.pivoterrors, rtol=0,
                               atol=ERR_ATOL)
    np.testing.assert_allclose(out.bonderrors, ref.bonderrors, rtol=0,
                               atol=ERR_ATOL)


@pytest.mark.parametrize("mode", ["eager", "replayed"])
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_one_key_follows_abstol_and_maxbonddim(problem, mode):
    """Two calls of one 2-site sweep program, the first cut off by a loose
    abstol and maxbonddim 2, the second at 1e-12 with the callers' default
    maxbonddim of 2^62: each equals tci_tpu's engine, so the program bakes
    in neither."""
    dims, bj, bt = _pair(problem, mode)
    ref, out = _start(dims, bj, bt)
    empty = [[] for _ in dims]
    engine = bt.device_sweep_engine
    for abstol, maxbonddim in ((1e-3, 2), (1e-12, 2 ** 62)):
        for tci, eng in ((ref, bj.device_sweep_engine), (out, engine)):
            tci.flushpivoterror()
            assert eng.sweep2site(tci, True, 1e-14, abstol, maxbonddim,
                                  empty, empty)
        _same_state(out, ref)
        if maxbonddim == 2:
            assert max(len(s) for s in out.Iset) == 2
    assert max(len(s) for s in out.Iset) > 2
    assert list(engine._sweeps) == [(True, engine.Imax)]
    program, = engine.programs()
    assert program["uses"] == 2
    assert program["captured"] == (mode == "replayed")
    # first use: the capture and a replay; second use: a replay
    assert engine.replays == program["replays"] == (
        2 if mode == "replayed" else 0)
    assert engine.captures == (1 if mode == "replayed" else 0)
    assert not engine.declined


@pytest.mark.parametrize("mode", ["eager", "replayed"])
def test_fill_and_sweep1site_programs_match_tci_tpu(mode):
    """The other keys: a backward sweep with the fill, the fill alone and
    the 1-site sweep at two maxbonddim values, each against tci_tpu's."""
    dims, bj, bt = _pair("4^5", mode)
    ref, out = _start(dims, bj, bt)
    empty = [[] for _ in dims]
    ej, et = bj.device_sweep_engine, bt.device_sweep_engine
    for tci, eng in ((ref, ej), (out, et)):
        assert eng.sweep2site(tci, True, 1e-14, 1e-12, 2 ** 62, empty, empty)
        assert eng.sweep2site(tci, False, 1e-14, 1e-12, 2 ** 62, empty,
                              empty, fill_sites=True)
    _same_state(out, ref)

    def tensors_match(rtol):
        pts = np.asarray(list(itertools.product(*map(range, dims))))
        full = tci_tpu_torch.TensorTrain(out.sitetensors()).evaluate_batch(
            pts).numpy().reshape(dims)
        np.testing.assert_allclose(
            full, tci_tpu.fulltensor(tci_tpu.tensortrain(ref)), rtol=rtol,
            atol=0)

    # the tensor trains: the triangular solves round differently, so the
    # full tensors agree to rtol 1e-10 (tests/test_torch_device_sweep.py)
    tensors_match(1e-10)
    for tci, eng in ((ref, ej), (out, et)):
        tci.invalidatesitetensors()
        assert eng.fillsitetensors(tci)
    tensors_match(1e-10)
    for maxbonddim in (3, 2 ** 62):
        for tci, eng in ((ref, ej), (out, et)):
            tci.flushpivoterror()
            assert eng.sweep1site(tci, True, 1e-14, 1e-12, maxbonddim)
        _same_state(out, ref)
        tensors_match(1e-10)
    assert out.linkdims() == [3] * (len(dims) - 1)
    Imax = et.Imax
    assert list(et._sweeps) == [(True, Imax), (False, Imax, "fused_full"),
                                ("fill", Imax), ("sweep1", True, Imax)]
    assert [p["uses"] for p in et.programs()] == [1, 1, 1, 2]
    assert et.rrlu_calls == 4 * (len(dims) - 1) + 2


@pytest.mark.parametrize("problem", ["4^5", "R8"])
def test_site_tensors_survive_the_next_call(problem):
    """What a call stores on its TensorCI2 is not the programs' storage:
    the site tensors of one crossinterpolate2 result are bit-identical
    after a second call on the same evaluator has replayed every program."""
    dims, make = PROBLEMS[problem]
    _, ft = make(dims)
    bt = tci_tpu_torch.TorchBatchEvaluator(ft, dims, device="cpu")
    engine = emulate_graphs(bt.device_sweep_engine)

    def solve(seed):
        return tci_tpu_torch.crossinterpolate2(
            np.float64, bt, dims, tolerance=1e-10, device="cpu",
            rng=np.random.default_rng(seed))

    first, ranks, errors = solve(0)
    held = first.sitetensors()
    before = [t.clone() for t in held]
    captures, replays = engine.captures, engine.replays
    second, ranks2, errors2 = solve(0)
    assert engine.captures == captures and engine.replays == 2 * replays
    assert all(p["captured"] for p in engine.programs())
    for t, b in zip(held, before):
        assert torch.equal(t, b)
    # and the same inputs through the same programs give the same result
    assert ranks2 == ranks and errors2 == errors
    for t, b in zip(second.sitetensors(), before):
        assert torch.equal(t, b)
    assert float(first._maxsample_dev if first._maxsample_dev is not None
                 else first.maxsamplevalue) == second.maxsamplevalue


def test_growth_makes_a_new_key_and_keeps_the_old():
    """An engine started at a capacity of 4 outgrows it: the programs of
    the larger capacity are new keys beside the old ones, and the result is
    tci_tpu's (tests/test_torch_device_sweep.py holds the eager engine's
    growth against it)."""
    dims, bj, bt = _pair("4^5", "replayed", imax=4)
    ref, rranks, rerrs = tci_tpu.crossinterpolate2(
        np.float64, bj, dims, tolerance=1e-10, rng=np.random.default_rng(0))
    out, oranks, oerrs = tci_tpu_torch.crossinterpolate2(
        np.float64, bt, dims, tolerance=1e-10, rng=np.random.default_rng(0),
        device="cpu")
    assert oranks == rranks
    assert out.Iset == ref.Iset and out.Jset == ref.Jset
    np.testing.assert_allclose(oerrs, rerrs, rtol=0, atol=ERR_ATOL)
    engine = bt.device_sweep_engine
    assert engine.Imax == bj.device_sweep_engine.Imax > 4
    capacities = {key[1] if key[0] != "sweep1" else key[2]
                  for key in engine._sweeps}
    assert 4 in capacities and engine.Imax in capacities
    assert (True, 4) in engine._sweeps and (True, engine.Imax) in engine._sweeps
    assert engine._sweeps[True, 4].Iset.shape == (5, 4, 5)
    assert engine._sweeps[True, engine.Imax].Iset.shape == (5, engine.Imax, 5)


def test_failed_capture_is_declined_and_runs_eagerly(capsys):
    """An f that cannot be recorded (here: it raises while a capture is
    on) leaves every key it meets running eagerly, with the same result;
    the engine says so once and keeps each key's reason."""
    dims = [4] * 5
    _, ft = _lorentz(dims)
    capturing = [False]

    def f(idx):
        if capturing[0]:
            raise RuntimeError("reads a device value")
        return ft(idx)

    def solve(bt):
        return tci_tpu_torch.crossinterpolate2(
            np.float64, bt, dims, tolerance=1e-10, device="cpu",
            rng=np.random.default_rng(0))

    plain = tci_tpu_torch.TorchBatchEvaluator(ft, dims, device="cpu")
    ref, rranks, rerrs = solve(plain)

    bt = tci_tpu_torch.TorchBatchEvaluator(f, dims, device="cpu")
    engine = emulate_graphs(bt.device_sweep_engine)
    capture = engine._capture

    def failing_capture(body):
        capturing[0] = True
        try:
            return capture(body)
        finally:
            capturing[0] = False

    engine._capture = failing_capture
    out, oranks, oerrs = solve(bt)
    assert oranks == rranks and oerrs == rerrs
    assert out.Iset == ref.Iset and out.Jset == ref.Jset
    for a, b in zip(out.sitetensors(), ref.sitetensors()):
        assert torch.equal(a, b)
    assert engine.captures == 0 and engine.replays == 0
    # the default protocol's programs: the optimize loop's step and the
    # final 1-site sweep
    assert set(engine.declined) == set(engine._sweeps)
    assert {key[0] for key in engine.declined} == {"oloop", "sweep1"}
    assert all("reads a device value" in why
               for why in engine.declined.values())
    assert all(p["declined"] and not p["captured"]
               for p in engine.programs())
    said = capsys.readouterr().err
    assert said.count("runs it eagerly") == 1
    assert "DeviceSweepEngine.declined" in said
    # a declined key is not tried again
    solve(bt)
    assert engine.captures == 0
    assert capsys.readouterr().err == ""
    assert bt.device == torch.device("cpu") and bt._fused_updater is None


@pytest.mark.parametrize("capture_at", [1, 2, 3])
def test_capture_at_the_nth_use(capture_at):
    """`capture_at` is the use of a key at which it is captured; the uses
    before it run eagerly, with the same results."""
    dims = [4] * 5
    _, ft = _lorentz(dims)
    bt = tci_tpu_torch.TorchBatchEvaluator(ft, dims, device="cpu")
    engine = emulate_graphs(bt.device_sweep_engine)
    engine.capture_at = capture_at
    tci = tci_tpu_torch.TensorCI2.from_function(bt, dims, device="cpu")
    empty = [[] for _ in dims]
    for use in range(1, 5):
        assert engine.sweep2site(tci, True, 1e-14, 1e-12, 2 ** 62, empty,
                                 empty)
        program, = engine.programs()
        assert program["uses"] == use
        assert program["captured"] == (use >= capture_at)
        assert program["replays"] == max(0, use - capture_at + 1)
    # switched off, a captured program runs eagerly again
    engine.cuda_graphs = False
    replays = engine.replays
    assert engine.sweep2site(tci, True, 1e-14, 1e-12, 2 ** 62, empty, empty)
    assert engine.replays == replays


def test_replay_counts_the_launches_its_graph_holds():
    """A replay adds the graph's launches to the kernel's count; a capture
    adds none (on the CPU no body launches the kernel, so a program's
    graph holds 0, and ``count_replay`` is what a CUDA replay calls)."""
    before = lu_cuda.LAUNCHES["rrlu"]
    lu_cuda.count_replay(7)
    assert lu_cuda.LAUNCHES["rrlu"] == before + 7
    lu_cuda.LAUNCHES["rrlu"] = before
    dims = [4] * 5
    bt = tci_tpu_torch.TorchBatchEvaluator(_lorentz(dims)[1], dims,
                                           device="cpu")
    engine = emulate_graphs(bt.device_sweep_engine)
    tci_tpu_torch.crossinterpolate2(np.float64, bt, dims, tolerance=1e-10,
                                    device="cpu",
                                    rng=np.random.default_rng(0))
    assert lu_cuda.LAUNCHES["rrlu"] == before
    assert lu_cuda.CAPTURED["rrlu"] == 0
    assert all(p["captured_launches"] == 0 for p in engine.programs())


def test_program_record_is_one_transfer():
    """A program's inputs are views of one device array, written from one
    staging array: index sets, lengths, tolerances, and the rank cap
    clamped to the capacity (the callers' default is 2^62)."""
    dims = [3, 4, 2, 3]
    bt = tci_tpu_torch.TorchBatchEvaluator(_lorentz(dims)[1], dims,
                                           device="cpu")
    engine = bt.device_sweep_engine
    program = engine._get_sweep(True, False)
    Iset = [[()], [(0,), (2,)], [(0, 1)], [(0, 1, 1), (2, 3, 0), (1, 1, 1)]]
    Jset = [[(1, 0, 2)], [(0, 2), (1, 1)], [(2,)], [()]]
    extra = [[], [(1,)], [], []]
    empty = [[] for _ in dims]
    program.load(Iset, Jset, extra, empty, reltol=1e-14, abstol=2.5e-9,
                 maxbonddim=2 ** 62)
    base = program._record.untyped_storage().data_ptr()
    for name in ("Iset", "Ilen", "Jset", "Jlen", "eI", "eIlen", "eJ",
                 "eJlen", "reltol", "abstol", "maxbond"):
        assert getattr(program, name).untyped_storage().data_ptr() == base
    assert program.Ilen.tolist() == [1, 2, 1, 3]
    assert program.Jlen.tolist() == [1, 2, 1, 1]
    assert program.eIlen.tolist() == [0, 1, 0, 0]
    assert program.Iset[3, 1].tolist() == [2, 3, 0, 0]
    assert program.Jset[0, 0].tolist() == [1, 0, 2, 0]
    assert program.eI[1, 0].tolist() == [1, 0, 0, 0]
    assert program.reltol.tolist() == [1e-14]
    assert program.abstol.tolist() == [2.5e-9]
    assert int(program.maxbond) == engine.Imax
    # a second load leaves nothing of the first behind
    program.load([[()], [], [], []], [[], [], [], [()]], empty, empty,
                 reltol=0.0, abstol=0.0, maxbonddim=5)
    assert program.Ilen.tolist() == [1, 0, 0, 0]
    assert int(program.Iset.abs().sum()) == 0 and int(program.eIlen.sum()) == 0
    assert int(program.maxbond) == 5


def _poly(X):
    return (X ** 2).sum(dim=1) + X[:, 0] * X[:, 1]


def test_integrate_keeps_its_evaluator():
    """``integrate(torch_native=True)`` twice on one f, bounds, GK order,
    type and device runs one evaluator, hence one engine and its programs;
    the integral is the same, nevals are per call, other bounds get another
    evaluator, and the entry goes with f."""
    made = []
    make = integration._torch_native_evaluator

    def counting(*args):
        made.append(make(*args))
        return made[-1]

    integration._torch_native_evaluator = counting
    try:
        def f(X):
            return _poly(X)

        def run(b=1.0):
            return tci_tpu_torch.integrate(
                np.float64, f, [0.0] * 3, [b] * 3, GKorder=7,
                tolerance=1e-10, torch_native=True, device="cpu",
                rng=np.random.default_rng(0))

        first = run()
        F, = made
        nevals, programs = F.nevals, list(F.device_sweep_engine._sweeps)
        uses = [p["uses"] for p in F.device_sweep_engine.programs()]
        second = run()
        assert len(made) == 1 and second == first
        # 3 * 1/3 + 1/4, exact for a GK rule of this order
        assert abs(first - 1.25) < 1e-12
        assert F.nevals == nevals
        assert list(F.device_sweep_engine._sweeps) == programs
        assert [p["uses"] for p in F.device_sweep_engine.programs()] == [
            2 * u for u in uses]
        run(b=2.0)
        assert len(made) == 2
        assert len(integration._GK_EVAL_CACHE[f]) == 2
        n = len(integration._GK_EVAL_CACHE)
        del f, F, run
        made.clear()
        gc.collect()
        assert len(integration._GK_EVAL_CACHE) == n - 1
    finally:
        integration._torch_native_evaluator = make
