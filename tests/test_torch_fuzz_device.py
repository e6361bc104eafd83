"""Seeded fuzz sweeps of the port's device tiers against its host oracles
and against tci_tpu, on the CPU: the seven sweeps of
``tests/test_fuzz_device.py`` with the same master seeds and draws
(``_torch_fuzz.py``): device compression, device contraction, rook on the
engine, complex128 on the engine (native, where tci_tpu runs its (re, im)
pair loop), the conversion round trips, the engine's floating-zone program
and TCI1 against its oracle.

Every trial is a case of one parametrized test per sweep. The first two
trials of each run in tier 1; the others are marked ``slow``, as all of
tci_tpu's are (run them with ``-m slow``).

Each trial holds the port's device tier against the port's host oracle
with the tolerance of tci_tpu's sweep, and the port against tci_tpu's host
tier on the same numpy inputs: linkdims identical, full tensors within
the sweep's tolerance. Where the two packages' rounding may part pivot
sets at ties (ROADMAP C-port-8, C-port-15) ranks and errors are compared,
not pivots.
"""

import numpy as np
import pytest
import torch

import _torch_fuzz as fz
import tci_tpu
from tci_tpu.models.contraction import contract as contract_ref
from tci_tpu.models.conversion import (tci1_from_tci2, tci2_from_tci1,
                                       tci2_from_tensortrain)
from tci_tpu.models.globalsearch import _floatingzone_batch
from tci_tpu.models.tensortrain import fulltensor as fulltensor_ref
from tci_tpu.parallel.batcheval import VectorizedBatchEvaluator as JaxVBE

torch.set_num_threads(1)


def trials(sweep):
    return [k if k < 2 else pytest.param(k, marks=pytest.mark.slow)
            for k in range(fz.NTRIALS[sweep])]


def _close(a, b, atol):
    return np.allclose(a, b, rtol=0, atol=atol)


@pytest.mark.parametrize("trial", trials("compress"))
def test_fuzz_compress_device_vs_host(trial):
    case = fz.compress_case(trial)
    cfg = case["cfg"]
    h_ld, h_full, d_ld, d_full = fz.run_compress(case, "cpu")
    assert d_ld == h_ld, cfg
    scale = max(1.0, np.abs(h_full).max())
    assert _close(h_full, d_full, 1e-8 * scale), cfg
    assert not np.any(np.isnan(d_full)), cfg
    ref = tci_tpu.TensorTrain(case["cores"])
    ref.compress("LU", **case["kw"])
    assert ref.linkdims() == h_ld, cfg
    assert _close(fulltensor_ref(ref), d_full, 1e-8 * scale), cfg


@pytest.mark.parametrize("trial", trials("contraction"))
def test_fuzz_contraction_device_vs_host(trial):
    case = fz.contraction_case(trial)
    cfg = case["cfg"]
    h_ld, h_full, d_ld, d_full = fz.run_contraction(case, "cpu")
    assert not np.any(np.isnan(d_full)), cfg
    assert max(d_ld) <= case["mbd"], cfg
    ref = contract_ref(tci_tpu.TensorTrain(case["A"]),
                       tci_tpu.TensorTrain(case["B"]), **case["kw"])
    assert ref.linkdims() == h_ld, cfg
    scale = max(1.0, np.abs(h_full).max())
    assert _close(fulltensor_ref(ref), h_full, 1e-7 * scale), cfg
    if case["capped"]:
        return
    assert d_ld == h_ld, cfg
    assert _close(h_full, d_full, 1e-7 * scale), cfg


@pytest.mark.parametrize("trial", trials("rook"))
def test_fuzz_rook_device_converges(trial):
    """Rook on the engine reproduces the enumerated tensor to 1e-7 max|f|
    (rook trajectories are not bit-comparable to full search, so the oracle
    is f itself), as tci_tpu's host rook tier does on the same f; both
    trains agree to twice that."""
    case = fz.rook_case(trial)
    cfg = case["cfg"]
    _, _, _, full, calls = fz.run_rook(case, "cpu")
    assert calls > 0, cfg
    exact = fz.rook_exact(case)
    scale = np.abs(exact).max()
    assert np.abs(full - exact).max() < 1e-7 * scale, cfg
    c, w = case["c"], case["w"]
    f = JaxVBE(lambda idx: (1.0 / (1.0 + ((idx - c) ** 2 * w).sum(1))
                            + 0.1 * np.cos((idx * w).sum(1))),
               case["localdims"])
    ref, _, _ = tci_tpu.crossinterpolate2(
        np.float64, f, case["localdims"], tolerance=1e-9, pivotsearch="rook",
        rng=np.random.default_rng(trial))
    ref_full = fulltensor_ref(tci_tpu.tensortrain(ref))
    assert np.abs(ref_full - exact).max() < 1e-7 * scale, cfg
    assert np.abs(ref_full - full).max() < 2e-7 * scale, cfg


@pytest.mark.parametrize("trial", trials("complex"))
def test_fuzz_complex_loop_vs_host(trial):
    """The complex128 engine against the host tier's scalar f (identical
    linkdims, full tensors within 1e-8), and tci_tpu's host tier on the
    same scalar f."""
    case = fz.complex_case(trial)
    cfg = case["cfg"]
    e_ld, e_full, h_ld, h_full = fz.run_complex(case, "cpu")
    assert e_ld == h_ld, cfg
    assert _close(e_full, h_full, 1e-8), cfg
    ref, _, _ = tci_tpu.crossinterpolate2(
        np.complex128, fz.complex_scalar(case), case["localdims"],
        rng=np.random.default_rng(trial), **case["kw"])
    assert ref.linkdims() == h_ld, cfg
    assert _close(fulltensor_ref(tci_tpu.tensortrain(ref)), h_full, 1e-8), cfg


@pytest.mark.parametrize("trial", trials("conversion"))
def test_fuzz_conversion_roundtrips(trial):
    """TCI2 -> TT -> TCI2 and TCI2 -> TCI1 -> TCI2 keep linkdims and values
    (1e-9 / 1e-8 of max|f|), as tci_tpu's conversions do on its own TCI2 of
    the same f."""
    case = fz.conversion_case(trial)
    cfg = case["cfg"]
    out = fz.run_conversion(case, "cpu")
    ld, ft = out["tci2"]
    scale = np.abs(ft).max()
    assert out["from_tt"][0] == ld, cfg
    assert _close(out["from_tt"][1], ft, 1e-9 * scale), cfg
    assert out["tci1"][0] == ld and out["back"][0] == ld, cfg
    assert _close(out["back"][1], ft, 1e-8 * scale), cfg
    ref, _, _ = tci_tpu.crossinterpolate2(
        case["vt"], case["f"], case["localdims"], tolerance=1e-10,
        rng=np.random.default_rng(trial))
    assert ref.linkdims() == ld, cfg
    ref_ft = fulltensor_ref(tci_tpu.tensortrain(ref))
    assert _close(ref_ft, ft, 1e-9 * scale), cfg
    ref_tb = tci2_from_tensortrain(tci_tpu.tensortrain(ref), tolerance=1e-12)
    assert ref_tb.linkdims() == ld, cfg
    ref_back = tci2_from_tci1(tci1_from_tci2(ref, case["f"]))
    assert ref_back.linkdims() == ld, cfg
    assert _close(fulltensor_ref(tci_tpu.tensortrain(ref_back)),
                  out["back"][1], 2e-8 * scale), cfg


@pytest.mark.parametrize("trial", trials("floatingzone"))
def test_fuzz_floatingzone_device_vs_host(trial):
    """The engine's floating-zone program against the host lock-step search
    from the same starts: errors sorted, the best pivot the host's and its
    error within 1e-9 relative; tci_tpu's host TCI and search of the same
    f give the same linkdims and the same best error (1e-9 relative)."""
    case = fz.floatingzone_case(trial)
    cfg = case["cfg"]
    ld, dev, host = fz.run_floatingzone(case, "cpu")
    assert len(dev) > 0, cfg
    errs = [e for _, e in dev]
    assert errs == sorted(errs, reverse=True), cfg
    host_best = max(host, key=lambda pe: pe[1])
    assert dev[0][0] == host_best[0], cfg
    assert np.isclose(dev[0][1], host_best[1], rtol=1e-9), cfg
    f = JaxVBE(fz.floatingzone_np(case), case["localdims"])
    ref, _, _ = tci_tpu.crossinterpolate2(
        np.float64, f, case["localdims"], tolerance=1e-2, maxbonddim=3,
        rng=np.random.default_rng(trial))
    assert ref.linkdims() == ld, cfg
    ref_host = _floatingzone_batch(tci_tpu.tensortrain(ref), f,
                                   case["starts"])
    assert np.isclose(max(e for _, e in ref_host), dev[0][1], rtol=1e-9), cfg


@pytest.mark.parametrize("trial", trials("tci1"))
def test_fuzz_tci1_vs_oracle(trial):
    """TCI1 reproduces the enumerated tensor to 1e-8 max|f|, real and
    complex, forward and back-and-forth, with tci_tpu's ranks, linkdims and
    errors (1e-15 absolute)."""
    case = fz.tci1_case(trial)
    cfg = case["cfg"]
    ranks, errors, ld, full = fz.run_tci1(case, "cpu")
    exact = fz.tci1_exact(case)
    assert np.abs(full - exact).max() < 1e-8 * np.abs(exact).max(), cfg
    ref, rranks, rerrors = tci_tpu.crossinterpolate1(
        case["vt"], case["f"], case["localdims"],
        [0] * len(case["localdims"]), **case["kw"])
    assert ranks == rranks and ld == ref.linkdims(), cfg
    np.testing.assert_allclose(errors, rerrors, rtol=0, atol=1e-15)
