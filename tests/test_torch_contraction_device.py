"""The device tiers of contraction in tci_tpu_torch against tci_tpu's, on the
same numpy data: ``_lu_split`` directly, zip-up and naive with
``torch_native=True`` against tci_tpu's ``jax_native=True`` (and the host
tiers against each other), the product evaluator against ``Contraction``
and tci_tpu's. The port runs on device="cpu", its rrLU the plain version;
complex operands run in complex128, against tci_tpu's (re, im) pair
programs. The cases of tests/test_contraction_device.py, each through both
packages, but for its TCI cases: those are in test_torch_contraction.py,
beside the host tier's (this file would otherwise outgrow a minute).

Tolerances: ``_lu_split`` the same rank, left @ right within 1e-12
relative, and for full-rank panels the factors themselves (so the pivot
order) within 1e-12; zip-up, naive and the product evaluator: linkdims
identical and values within 1e-12 relative of tci_tpu's (the einsums round
apart in XLA and torch).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tci_tpu
import tci_tpu_torch
from tci_tpu.models import contraction as jc
from tci_tpu.models import contraction_device as jcd
from tci_tpu_torch.models import contraction as pc
from tci_tpu_torch.models import contraction_device as pcd
from tci_tpu_torch.ops import lu_kernel
from tci_tpu_torch.utils.device import FETCHES

torch.set_num_threads(1)


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _rand_mpo(rng, L, chi, d1, d2, complex_=False):
    bonds = [1] + [chi] * (L - 1) + [1]
    out = []
    for n in range(L):
        t = rng.standard_normal((bonds[n], d1, d2, bonds[n + 1]))
        if complex_:
            t = t + 1j * rng.standard_normal(t.shape)
        out.append(t)
    return out


def _lowrank_mpo(rng, L, chi, d1, d2, r):
    bonds = [1] + [chi] * (L - 1) + [1]
    ts = []
    for n in range(L):
        u = rng.standard_normal((bonds[n], d1, d2, r))
        v = rng.standard_normal((r, bonds[n + 1]))
        ts.append((u @ v) / np.sqrt(r))
    return ts


def _rank_deficient_mpo(rng):
    """test_device_naive_rank_deficient_no_nan's operand: a duplicated bond
    channel, so that the merged cores are exactly singular."""
    core = _rand_mpo(rng, 4, 2, 3, 3)
    core[1][..., 1] = core[1][..., 0]
    core[2][1, ...] = core[2][0, ...]
    return core


# the operands, each a list of numpy cores, made once from fixed seeds
@functools.cache
def _operands(name):
    rng = np.random.default_rng(1234)
    if name == "rand":
        return _rand_mpo(rng, 5, 4, 3, 3), _rand_mpo(rng, 5, 5, 3, 2)
    if name == "lowrank":
        return (_lowrank_mpo(rng, 5, 8, 3, 3, 2),
                _lowrank_mpo(rng, 5, 8, 3, 2, 2))
    if name == "small":
        return _rand_mpo(rng, 4, 3, 3, 3), _rand_mpo(rng, 4, 4, 3, 2)
    if name == "complex":
        return (_rand_mpo(rng, 4, 3, 2, 2, True),
                _rand_mpo(rng, 4, 3, 2, 2, True))
    if name == "complex4":
        return (_rand_mpo(rng, 4, 4, 2, 2, True),
                _rand_mpo(rng, 4, 4, 2, 2, True))
    if name == "mixed":
        a = _rand_mpo(rng, 3, 2, 2, 2)
        return ([t.astype(np.complex128) * (1 + 0.5j) for t in a],
                _rand_mpo(rng, 3, 2, 2, 2))
    if name == "deficient":
        return _rank_deficient_mpo(rng), _rand_mpo(rng, 4, 3, 3, 2)
    if name == "mps":
        B = _rand_mpo(rng, 4, 5, 3, 2)
        return B, [rng.standard_normal((b1, 2, b2))
                   for b1, b2 in zip([1, 3, 3, 3], [3, 3, 3, 1])]
    raise KeyError(name)


def _trains(name):
    a, b = _operands(name)
    return ((tci_tpu.TensorTrain([t.copy() for t in a]),
             tci_tpu.TensorTrain([t.copy() for t in b])),
            (tci_tpu_torch.TensorTrain(a, device="cpu"),
             tci_tpu_torch.TensorTrain(b, device="cpu")))


# tci_tpu's results, each computed once for the module (its device tiers
# compile one XLA program a shape signature)
@functools.cache
def _reference(name, algorithm, native, **kw):
    (ja, jb), _ = _trains(name)
    return jc.contract(ja, jb, algorithm=algorithm, jax_native=native, **kw)


def _full(tt):
    if isinstance(tt, tci_tpu_torch.TensorTrain):
        return tci_tpu_torch.fulltensor(tt).numpy()
    return np.asarray(tci_tpu.fulltensor(tt))


def _check(name, algorithm, tol=1e-12, **kw):
    """The port's device and host tiers against tci_tpu's, and the device
    tier's one fetch; returns the port's device result."""
    _, (pa, pb) = _trains(name)
    key = "contract_" + algorithm
    fetches = FETCHES[key]
    out = pc.contract(pa, pb, algorithm=algorithm, torch_native=True, **kw)
    assert FETCHES[key] == fetches + 1
    ref = _reference(name, algorithm, True, **kw)
    assert out.linkdims() == ref.linkdims()
    assert str(out[0].dtype)[6:] == str(np.asarray(ref[0]).dtype)
    assert _rel(_full(out), _full(ref)) < tol
    host = pc.contract(pa, pb, algorithm=algorithm, **kw)
    href = _reference(name, algorithm, False, **kw)
    assert host.linkdims() == href.linkdims()
    assert _rel(_full(host), _full(href)) < tol
    return out


@functools.cache
def _exact(name):
    """The dense product: tci_tpu's naive contraction, untruncated."""
    (ja, jb), _ = _trains(name)
    return _full(jc.contract(ja, jb, algorithm="naive", tolerance=0.0))


# -- _lu_split ---------------------------------------------------------------


def _panel(case):
    rng = np.random.default_rng(7)
    if case == "complex":
        return rng.standard_normal((12, 9)) + 1j * rng.standard_normal((12, 9))
    if case in ("full", "cap"):
        return rng.standard_normal((12, 9))
    low = rng.standard_normal((12, 3)) @ rng.standard_normal((3, 9))
    if case == "deficient":
        return low
    return low + 1e-9 * rng.standard_normal((12, 9))


# (panel, reltol, abstol, cap, the rank both must reach)
SPLITS = {
    "full": ("full", 0.0, 0.0, 9, 9),
    "reltol": ("noisy", 1e-6, 0.0, 9, 3),
    "abstol": ("noisy", 0.0, 1e-6, 9, 3),
    "cap": ("cap", 0.0, 0.0, 4, 4),
    "deficient": ("deficient", 0.0, 0.0, 9, None),
    "complex": ("complex", 0.0, 0.0, 9, 9),
}


@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("case", sorted(SPLITS))
def test_lu_split_matches(case, leftorthogonal):
    panel, reltol, abstol, cap, rank = SPLITS[case]
    C = _panel(panel)
    m, n = C.shape
    ref = jcd._lu_split(jnp.asarray(C), jnp.int32(m), jnp.int32(n),
                        jnp.float64(reltol), jnp.float64(abstol), cap=cap,
                        leftorthogonal=leftorthogonal)
    lref, rref, kref = (np.asarray(x) for x in ref)
    left, right, k = pcd._lu_split(torch.from_numpy(C), m, n, reltol, abstol,
                                   cap=cap, leftorthogonal=leftorthogonal)
    assert left.shape == (m, cap) and right.shape == (cap, n)
    assert int(k) == int(kref)
    if rank is not None:
        assert int(k) == rank
    assert torch.isfinite(left).all() and torch.isfinite(right).all()
    assert _rel(left @ right, lref @ rref) < 1e-12
    if case in ("full", "cap", "complex"):
        # full rank: the same pivots in the same order
        assert _rel(left, lref) < 1e-12 and _rel(right, rref) < 1e-12
    # the columns of left and rows of right past the rank are zero
    assert not left[:, int(k):].any() and not right[int(k):].any()


def test_lu_split_widens_an_unaligned_panel():
    """An odd (m, n) float64 panel holds 8 bytes short of a multiple of 16,
    which the kernel's bulk copy needs; it goes to the elimination widened
    by zero columns past its true extents, with the same result."""
    C = torch.from_numpy(np.random.default_rng(3).standard_normal((5, 7)))
    assert lu_kernel.aligned_panel(C).shape == (5, 8)
    assert lu_kernel.aligned_panel(C[:, :6].contiguous()).shape == (5, 6)
    ref = lu_kernel.rrlu_plain(C, 5, 7, 5, 0.0, 0.0, leftorthogonal=False)
    left, right, k = pcd._lu_split(C, 5, 7, 0.0, 0.0, cap=5,
                                   leftorthogonal=False)
    assert int(k) == int(ref[3]) == 5
    assert _rel(left @ right, C) < 1e-13


# -- zip-up -------------------------------------------------------------------


def test_device_zipup_matches_host():
    out = _check("rand", "zipup", tolerance=1e-10, method="LU")
    assert _rel(_full(out), _exact("rand")) < 1e-12


def test_device_zipup_maxbonddim_matches_host():
    out = _check("rand", "zipup", tolerance=1e-10, method="LU", maxbonddim=6)
    assert out.linkdims() == [6, 6, 6, 6]


def test_device_zipup_tolerance_truncates():
    out = _check("lowrank", "zipup", tolerance=1e-8, method="LU")
    assert max(out.linkdims()) < 64  # genuinely truncated
    assert _rel(_full(out), _exact("lowrank")) < 1e-7


def test_device_zipup_via_contract_mps():
    out = _check("mps", "zipup", tolerance=1e-10, method="LU")
    assert all(t.dim() == 3 for t in out.sitetensors())
    assert _rel(_full(out), _exact("mps")) < 1e-12


def test_device_zipup_rejects_nonlu(monkeypatch):
    """The device zip-up takes method "LU" only. A mesh is taken by the
    zip-up and the naive contraction: every split goes to the mesh's split
    (``make_lu_split_sharded``, here a stand-in that runs the one-device
    split; the real one is held against this tier bitwise in
    tests/test_torch_contraction_mesh.py)."""
    _, (pa, pb) = _trains("small")
    with pytest.raises(ValueError, match="method='LU'"):
        pc.contract_zipup(pa, pb, method="SVD", torch_native=True)
    mesh, calls = object(), []

    def split_on(m, *shape):
        calls.append(m)
        cap, lo = shape[2], shape[3]
        return lambda Cm, mt, nt, rt, at: pcd._lu_split(
            Cm, mt, nt, rt, at, cap=cap, leftorthogonal=lo)

    monkeypatch.setattr(pcd, "make_lu_split_sharded", split_on)
    for run in (pcd.contract_zipup_device,
                functools.partial(pcd.contract_naive_device,
                                  tolerance=1e-10)):
        calls.clear()
        out, ref = run(pa, pb, mesh=mesh), run(pa, pb)
        assert calls and all(m is mesh for m in calls)
        assert out.linkdims() == ref.linkdims()
        assert all(torch.equal(a, b)
                   for a, b in zip(out.sitetensors(), ref.sitetensors()))


def test_device_zipup_complex_matches_pair():
    """Complex zip-up in complex128 against tci_tpu's (re, im) pair
    program and its host LU zip-up."""
    out = _check("complex", "zipup", tolerance=1e-10, method="LU")
    assert out[0].dtype == torch.complex128
    assert _rel(_full(out), _exact("complex")) < 1e-12


def test_device_zipup_complex_truncates():
    out = _check("complex4", "zipup", tolerance=1e-10, method="LU",
                 maxbonddim=5)
    assert max(out.linkdims()) <= 5


# -- naive --------------------------------------------------------------------


def test_device_naive_exact_product():
    out = _check("small", "naive")
    assert _rel(_full(out), _exact("small")) < 1e-12
    # tolerance 0 and no maxbonddim: the merged cores, nothing to fetch
    (ja, jb), (pa, pb) = _trains("small")
    fetches = FETCHES["contract_naive"]
    out = pc.contract_naive(pa, pb, torch_native=True)
    assert FETCHES["contract_naive"] == fetches
    ref = jc.contract_naive(ja, jb, jax_native=True)
    assert out.linkdims() == ref.linkdims()
    assert _rel(_full(out), _full(ref)) < 1e-12


def test_device_naive_compress_truncates():
    out = _check("lowrank", "naive", tolerance=1e-8)
    assert max(out.linkdims()) <= 8
    assert _rel(_full(out), _exact("lowrank")) < 1e-6


def test_device_naive_maxbonddim():
    out = _check("small", "naive", tolerance=1e-12, maxbonddim=5)
    assert max(out.linkdims()) <= 5


def test_device_naive_complex_promotes_mixed():
    """A complex x real pair runs in complex128 (the promoted type)."""
    out = _check("mixed", "naive", tolerance=1e-12)
    assert out[0].dtype == torch.complex128
    assert _rel(_full(out), _exact("mixed")) < 1e-12


def test_device_naive_complex_matches_pair():
    out = _check("complex", "naive", tolerance=1e-10)
    assert _rel(_full(out), _exact("complex")) < 1e-10
    out = _check("complex", "naive", tolerance=1e-12, maxbonddim=5)
    assert max(out.linkdims()) <= 5


def test_device_naive_rank_deficient_no_nan():
    """Exactly rank-deficient Kronecker merges: the reltol = abstol = 0
    exact pass stops at the first exactly zero pivot, or eliminates
    rounding noise past the rank; either way no NaN, and tci_tpu's ranks
    (contraction_device.py:384-389: pivot sets need not be equal)."""
    out = _check("deficient", "naive", tol=1e-8)
    full = _full(out)
    assert np.all(np.isfinite(full))
    assert _rel(full, _exact("deficient")) < 1e-8


# -- product evaluator --------------------------------------------------------


@pytest.mark.parametrize("name", ["rand", "complex"])
def test_product_evaluator_matches_contraction(name):
    """At every point of a 4-site grid (rand: the first four sites' 6^4
    points, the last fixed; complex: all 4^4) against Contraction.evaluate
    and tci_tpu's evaluator vmapped."""
    (ja, jb), (pa, pb) = _trains(name)
    f, localdims, dtype, pair = pcd.make_product_evaluator(pa, pb)
    fjax, ldj, _, _ = jcd.make_product_evaluator(ja, jb)
    assert pair is False and localdims == ldj
    grid = np.stack(np.meshgrid(*[np.arange(d) for d in localdims[:4]],
                                indexing="ij"), -1).reshape(-1, 4)
    idx = np.concatenate([grid, np.ones((len(grid), len(localdims) - 4),
                                        dtype=grid.dtype)], 1)
    got = f(torch.from_numpy(idx))
    assert got.shape == (len(idx),) and got.dtype == dtype
    want = np.asarray(jax.vmap(fjax)(jnp.asarray(idx, dtype=jnp.int32)))
    assert _rel(got, want) < 1e-12
    prod = pc.Contraction(pa, pb)
    vals = np.array([prod.evaluate_single([int(x) for x in row])
                     for row in idx[::17]])
    assert _rel(got[::17], vals) < 1e-12


@pytest.mark.parametrize("name,post", [("small", lambda x: 2.0 * x),
                                       ("complex", lambda z: 2j * z),
                                       ("complex", lambda z: z ** 2)])
def test_product_evaluator_postmap(name, post):
    """A torch elementwise post-map, also complex (tci_tpu's pair mode
    needed a pair-aware one; in complex128 any complex map applies)."""
    (ja, jb), (pa, pb) = _trains(name)
    f, localdims, _, _ = pcd.make_product_evaluator(pa, pb, f=post)
    fjax, _, _, _ = jcd.make_product_evaluator(ja, jb, f=post)
    idx = [1, 0, 3, 2]
    got = complex(f(torch.tensor([idx]))[0])
    want = complex(fjax(jnp.asarray(idx, dtype=jnp.int32)))
    assert abs(got - want) < 1e-12 * abs(want)
    prod = pc.Contraction(pa, pb, f=post)
    assert abs(got - prod.evaluate_single(idx)) < 1e-12 * abs(want)


def test_product_evaluator_pair_raises():
    _, (pa, pb) = _trains("complex")
    with pytest.raises(ValueError, match="complex128"):
        pcd.make_product_evaluator(pa, pb, pair=True)
    _, (ra, rb) = _trains("small")
    with pytest.raises(ValueError, match="length"):
        pcd.make_product_evaluator(ra, tci_tpu_torch.TensorTrain(
            list(rb)[:3]))
