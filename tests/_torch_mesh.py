"""Gloo process groups on the CPU for the port's mesh tests.

``run_ranks(world, tmp_path, cases)`` spawns `world` processes, each of
which joins a gloo group on a ``file://`` store under `tmp_path` (no TCP
port, so concurrent test workers cannot collide), builds
``default_mesh(world, device="cpu")`` and runs ``CASES[cases](mesh)``: a
dict of named results, as numpy values. It returns the list of the ranks'
dicts. The inputs are made from numpy seeds by the functions here, so the
test process can hand the same inputs to tci_tpu and to the port's
one-device paths. This module imports neither jax nor tci_tpu.
"""

import os
import pickle
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

TIMEOUT = 300


def _worker(rank, world, tmp, cases, seed):
    out = os.path.join(tmp, f"rank{rank}.pkl")
    try:
        import torch.distributed as dist

        from tci_tpu_torch.parallel.mesh import default_mesh

        torch.set_num_threads(1)
        # a global numpy state of its own on every rank: an unseeded host
        # draw that a rank made alone would part the ranks
        np.random.seed(seed + 1000 * rank)
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=rank, world_size=world)
        try:
            mesh = default_mesh(world, device="cpu")
            res = CASES[cases](mesh)
        finally:
            dist.destroy_process_group()
        payload = ("ok", res)
    except Exception:
        payload = ("error", traceback.format_exc())
    with open(out, "wb") as fh:
        pickle.dump(payload, fh)


def run_ranks(world: int, tmp_path, cases: str, seed: int = 0) -> list:
    """Run CASES[cases] on `world` spawned gloo ranks; the ranks' dicts."""
    tmp = str(tmp_path)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, world, tmp, cases, seed))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    results = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.pkl")
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} of {world} left no result "
                               f"({'hung' if hung else 'died'})")
        with open(path, "rb") as fh:
            status, res = pickle.load(fh)
        if status != "ok":
            raise RuntimeError(f"rank {r} of {world} failed:\n{res}")
        results.append(res)
    return results


def same_on_every_rank(results: list, key: str) -> None:
    """Every rank returned the same value for `key` (bitwise)."""
    first = results[0][key]
    for r, res in enumerate(results[1:], start=1):
        a, b = res[key], first
        if isinstance(a, (list, tuple)):
            assert len(a) == len(b), (key, r)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                              err_msg=f"{key} rank {r}")
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{key} rank {r}")


# -- inputs -------------------------------------------------------------------


def lu_inputs() -> dict:
    """name -> (A, maxrank, reltol, abstol, leftorthogonal): the cases of
    tests/test_lu_sharded.py, drawn from fixed seeds."""
    rng = np.random.default_rng(1234)
    cases = {}
    for shape, lo in [((100, 37), True), ((64, 64), True), ((33, 129), False),
                      ((8, 8), False), ((7, 200), True)]:
        cases[f"full_{shape[0]}x{shape[1]}"] = (
            rng.standard_normal(shape), min(shape), 1e-14, 0.0, lo)
    U, V = rng.standard_normal((160, 6)), rng.standard_normal((6, 90))
    cases["truncation"] = (U @ V, 80, 1e-10, 0.0, True)
    A = rng.standard_normal((96, 96))
    cases["abstol_maxrank"] = (A, 17, 0.0, 1e-3, True)
    cases["abstol_half"] = (A, 96, 0.0, np.abs(A).max() / 2, False)
    cases["complex"] = (rng.standard_normal((48, 40))
                        + 1j * rng.standard_normal((48, 40)), 40, 1e-12, 0.0,
                        True)
    T = np.zeros((24, 24))
    T[3, 5] = T[11, 5] = T[3, 17] = 2.0
    T += 0.01 * np.arange(24)[:, None]
    cases["tie_break"] = (T, 24, 1e-14, 0.0, True)
    u = np.arange(1.0, 33.0)
    cases["exact_zero"] = (np.outer(u, u), 32, 0.0, 0.0, True)
    cases["float32_input"] = (rng.standard_normal((50, 30)).astype(np.float32),
                              30, 1e-14, 0.0, True)
    return cases


def panel_inputs() -> dict:
    """name -> (padded panel, m, n, maxrank, reltol, abstol, lo) for the
    step's plain version against the one-device plain elimination, in the
    kernel's three element types, with a NaN panel and a dead tail."""
    rng = np.random.default_rng(99)
    out = {}
    for name, dt in (("f32", np.float32), ("f64", np.float64)):
        A = np.zeros((64, 48), dtype=dt)
        A[:60, :45] = rng.standard_normal((60, 45))
        out[name] = (A, 60, 45, 45, 1e-6 if dt == np.float32 else 1e-12,
                     0.0, True)
    C = np.zeros((40, 32), dtype=np.complex128)
    C[:37, :30] = rng.standard_normal((37, 30)) + 1j * rng.standard_normal(
        (37, 30))
    out["c128_right"] = (C, 37, 30, 30, 1e-12, 0.0, False)
    N = rng.standard_normal((24, 16))
    N[5, 7] = np.nan
    out["nan"] = (N, 24, 16, 16, 1e-14, 0.0, True)
    L = np.zeros((32, 24))
    L[:30, :20] = rng.standard_normal((30, 3)) @ rng.standard_normal((3, 20))
    out["rank3_dead_tail"] = (L, 30, 20, 20, 1e-10, 0.0, False)
    return out


def lorentz(idx):
    v = idx.to(torch.float64) + 1.0
    return 1.0 / (1.0 + (v * v).sum(1))


def rand_mpo(rng, L, chi, d1, d2, complex_=False):
    """tests/test_contraction_mesh.py's _rand_mpo / _rand_cmpo."""
    bonds = [1] + [chi] * (L - 1) + [1]
    cores = []
    for n in range(L):
        shape = (bonds[n], d1, d2, bonds[n + 1])
        c = rng.standard_normal(shape)
        if complex_:
            c = c + 1j * rng.standard_normal(shape)
        cores.append(c)
    return cores


def contraction_inputs() -> dict:
    rng = np.random.default_rng(2024)
    out = {"zipup": (rand_mpo(rng, 5, 4, 3, 3), rand_mpo(rng, 5, 5, 3, 2)),
           "naive": (rand_mpo(rng, 4, 4, 3, 3), rand_mpo(rng, 4, 4, 3, 2)),
           "zipup_complex": (rand_mpo(rng, 4, 3, 2, 2, True),
                             rand_mpo(rng, 4, 3, 2, 2, True))}
    L, chi, d, r = 5, 8, 3, 3
    bonds = [1] + [chi] * (L - 1) + [1]
    out["compress"] = [
        rng.standard_normal((bonds[n], d, r))
        @ rng.standard_normal((r, bonds[n + 1])) / np.sqrt(r)
        for n in range(L)]
    L, chi = 4, 6
    bonds = [1] + [chi] * (L - 1) + [1]
    out["compress_complex"] = [
        rng.standard_normal((bonds[n], d, bonds[n + 1]))
        + 1j * rng.standard_normal((bonds[n], d, bonds[n + 1]))
        for n in range(L)]
    out["tci"] = (rand_mpo(rng, 4, 3, 2, 2), rand_mpo(rng, 4, 3, 2, 2))
    # a rank-3 panel whose split stops by reltol long before its cap of 70
    out["split_stop"] = (rng.standard_normal((90, 3))
                         @ rng.standard_normal((3, 70)))
    return out


# -- the cases each rank runs -------------------------------------------------


def _lu_cases(mesh):
    from tci_tpu_torch.ops import lu_sharded
    from tci_tpu_torch.ops.lu import rrlu

    res = {}
    for name, (A, maxrank, reltol, abstol, lo) in lu_inputs().items():
        LU, rp, cp, k, diag, err, flags = lu_sharded.rrlu_sharded_raw(
            A, maxrank, reltol, abstol, lo, mesh=mesh)
        res[name] = (LU.numpy(), rp, cp, k, diag, err)
    for name, (Ap, m, n, maxrank, reltol, abstol, lo) in \
            panel_inputs().items():
        t = torch.from_numpy(Ap)
        s = lu_sharded.rrlu_panel_sharded(
            t, m, n, maxrank, reltol, abstol, leftorthogonal=lo, mesh=mesh)
        res[f"panel_{name}"] = tuple(x.numpy() for x in s)
    out = lu_sharded.rrlu_sharded_raw(np.zeros((0, 5), dtype=np.complex128),
                                      mesh=mesh)
    res["empty_0x5"] = (str(out[0].dtype), out[3])
    out = lu_sharded.rrlu_sharded_raw(np.zeros((4, 0)), mesh=mesh)
    res["empty_4x0"] = (tuple(out[0].shape), out[3])
    rng = np.random.default_rng(7)
    A = rng.standard_normal((70, 9)) @ rng.standard_normal((9, 55))
    lu = lu_sharded.rrlu_sharded(A, reltol=1e-12, mesh=mesh)
    res["object"] = (lu.npivot, (lu.left() @ lu.right()).numpy(), A)
    A = rng.standard_normal((60, 7)) @ rng.standard_normal((7, 44))
    lu = rrlu(A, reltol=1e-12, mesh=mesh)
    res["rrlu_mesh"] = (lu.npivot, lu.rowpermutation, lu.colpermutation,
                        lu.left().numpy(), A)
    try:
        rrlu(A, pivotsearch="rook", mesh=mesh)
        res["rook_refused"] = ""
    except ValueError as e:
        res["rook_refused"] = str(e)
    from tci_tpu_torch.parallel.mesh import default_mesh
    try:
        default_mesh(2 * mesh.size(), device="cpu")
        res["too_many_ranks"] = ""
    except RuntimeError as e:
        res["too_many_ranks"] = str(e)
    res["plain_calls"] = lu_sharded.PLAIN_CALLS["cpu"]
    res["kernel_launches"] = lu_sharded.LAUNCHES["lu_sharded_step"]
    return res


def fzone_f(idx):
    """tests/test_multichip.py's floating-zone integrand."""
    v = idx.to(torch.float64) + 1.0
    return 1.0 / (1.0 + (v * v).sum(1)) + 0.05 * torch.cos(
        2.7 * v.prod(1) ** 0.5)


FZONE_STARTS = np.random.default_rng(3).integers(0, 4, (12, 5))


def tt_inputs():
    """tests/test_multichip.py's serving case: a train of linkdims (1, 3,
    5, 4, 1) and a batch of B = 37 indices."""
    rng = np.random.default_rng(5)
    linkdims = [1, 3, 5, 4, 1]
    cores = [rng.standard_normal((linkdims[i], 3, linkdims[i + 1]))
             for i in range(4)]
    return cores, rng.integers(0, 3, size=(37, 4))


def run_tci(bf, dims, **kw):
    """crossinterpolate2 on the CPU: (ranks, errors, value at a point,
    nevals)."""
    import tci_tpu_torch as tci

    t, ranks, errors = tci.crossinterpolate2(np.float64, bf, dims,
                                             device="cpu", **kw)
    return ranks, errors, t(tuple(i % d for i, d in zip((1, 2, 0, 2, 1),
                                                       dims))), bf.nevals


def integrand(x):
    return x.prod(1) + (x * x).sum(1)


def _multichip_cases(mesh):
    import tci_tpu_torch as tci
    from tci_tpu_torch.models.tteval import (pad_cores, tt_evaluate_batched,
                                             tt_evaluate_sharded)
    from tci_tpu_torch.parallel.mesh import mesh_rng

    res = {}
    bf = tci.TorchBatchEvaluator(lorentz, [4] * 6, device="cpu", mesh=mesh)
    idx = np.random.default_rng(0).integers(0, 4, size=(37, 6))
    res["evaluator"] = (bf.evaluate_many(idx).numpy(), bf.nevals,
                        bf.batch_evaluate([(0,), (1,)], [(2,), (3,)], 4)
                        .numpy())
    cores, idx = tt_inputs()
    padded = pad_cores([torch.from_numpy(c) for c in cores])
    idx = torch.from_numpy(idx)
    res["tt_eval"] = (tt_evaluate_sharded(padded, idx, mesh).numpy(),
                      tt_evaluate_batched(padded, idx).numpy())
    try:
        tci.integrate(np.float64, lambda x: 1.0, [0.0], [1.0], mesh=mesh,
                      device="cpu")
        res["integrate_requires_native"] = ""
    except ValueError as e:
        res["integrate_requires_native"] = str(e)
    # unseeded host draws: every rank has another global numpy state, and
    # the run must still be one run
    bf = tci.TorchBatchEvaluator(lorentz, [3] * 5, device="cpu", mesh=mesh)
    res["unseeded"] = run_tci(bf, [3] * 5, tolerance=1e-8, maxiter=4,
                              nsearchglobalpivot=5)[:3]
    res["unseeded_draws"] = (
        bf.device_sweep_engine._rng.integers(0, 2**31, 4),
        mesh_rng(mesh).integers(0, 2**62, 3))
    return res


def _multichip_slow_cases(mesh):
    import tci_tpu_torch as tci
    from tci_tpu_torch.models.globalsearch import estimatetrueerror
    from tci_tpu_torch.parallel import dryrun

    res = {}
    bf = tci.TorchBatchEvaluator(lorentz, [3] * 5, device="cpu", mesh=mesh)
    res["cross"] = run_tci(bf, [3] * 5, tolerance=1e-8, maxiter=4,
                           rng=np.random.default_rng(7))
    bf = tci.TorchBatchEvaluator(lorentz, [3] * 5, device="cpu", mesh=mesh)
    bf.device_sweep_engine._rng = np.random.default_rng(11)
    res["rook"] = run_tci(bf, [3] * 5, tolerance=1e-8, maxiter=4,
                          pivotsearch="rook", rng=np.random.default_rng(7))
    bf = tci.TorchBatchEvaluator(fzone_f, [4] * 5, device="cpu", mesh=mesh)
    t, _, _ = tci.crossinterpolate2(np.float64, bf, [4] * 5, tolerance=1e-2,
                                    maxbonddim=4, device="cpu",
                                    rng=np.random.default_rng(5))
    found = estimatetrueerror(tci.tensortrain(t), bf,
                              initialpoints=[tuple(map(int, s))
                                             for s in FZONE_STARTS])
    res["fzone"] = ([p for p, _ in found], [e for _, e in found])
    res["integrate"] = tci.integrate(
        np.float64, integrand, [0.0] * 4, [1.0] * 4, GKorder=15,
        torch_native=True, mesh=mesh, tolerance=1e-10,
        rng=np.random.default_rng(3), device="cpu")
    res["dryrun"] = dryrun.run(mesh.size(), device="cpu")
    return res


def _cores(tt):
    return [t.numpy() for t in tt.sitetensors()]


def _contraction_cases(mesh):
    from tci_tpu_torch.models.contraction import contract, contract_zipup
    from tci_tpu_torch.models.tensortrain import TensorTrain

    inp = contraction_inputs()
    res = {}
    for name in ("zipup", "zipup_complex"):
        A, B = (TensorTrain(x, device="cpu") for x in inp[name])
        res[name] = _cores(contract_zipup(A, B, tolerance=1e-10, method="LU",
                                          torch_native=True, mesh=mesh))
    A, B = (TensorTrain(x, device="cpu") for x in inp["naive"])
    res["naive"] = _cores(contract(A, B, algorithm="naive", tolerance=1e-10,
                                   torch_native=True, mesh=mesh))
    for name in ("compress", "compress_complex"):
        tt = TensorTrain(inp[name], device="cpu")
        tt.compress("LU", tolerance=1e-10, torch_native=True, mesh=mesh)
        res[name] = _cores(tt)
    msgs = []
    for algorithm in ("zipup", "naive"):
        try:
            contract(A, B, algorithm=algorithm, method="LU", mesh=mesh)
            msgs.append("")
        except ValueError as e:
            msgs.append(str(e))
    res["requires_native"] = msgs
    from tci_tpu_torch.ops import lu_sharded

    C = torch.from_numpy(inp["split_stop"])
    split = lu_sharded.make_lu_split_sharded(mesh, 90, 70, 70, True)
    plain, reads = (lu_sharded.PLAIN_CALLS["cpu"],
                    lu_sharded.FLAG_READS["stop"])
    left, right, kk = split(C, 90, 70, 1e-12, 0.0)
    res["split_stop"] = (left.numpy(), right.numpy(), int(kk),
                         (lu_sharded.PLAIN_CALLS["cpu"] - plain - 1) // 3,
                         lu_sharded.FLAG_READS["stop"] - reads)
    return res


def _contraction_slow_cases(mesh):
    from tci_tpu_torch.models.contraction import contract
    from tci_tpu_torch.models.tensortrain import TensorTrain, fulltensor

    A, B = (TensorTrain(x, device="cpu")
            for x in contraction_inputs()["tci"])
    kw = dict(algorithm="TCI", tolerance=1e-10, torch_native=True, mesh=mesh)
    tt = contract(A, B, rng=np.random.default_rng(3), **kw)
    res = {"tci": (tt.linkdims(), fulltensor(tt).numpy())}
    tt = contract(A, B, **kw)  # rng None: drawn from rank 0's seed
    res["tci_unseeded"] = (tt.linkdims(), fulltensor(tt).numpy())
    return res


CASES = {"lu": _lu_cases, "multichip": _multichip_cases,
         "multichip_slow": _multichip_slow_cases,
         "contraction": _contraction_cases,
         "contraction_slow": _contraction_slow_cases}
