"""The plain PyTorch versions of the six batched-grid probes
(tci_tpu_torch.ops.probe_batched) on the CPU: against closed forms written
from the Pallas bodies of benchmarks/probe_pallas_batched.py (each case
cites its lines), and against a copy of each body run by
``pl.pallas_call(..., interpret=True)``.

Inputs: the probe's own (B = 4, n = 256, its scalar tables), and a second
set (B = 5, n = 40, a numpy-seeded table with a loop limit of 0 in one row).
All values are int32, or float32 values that the operations keep exact, so
every comparison is for equality. The CUDA kernels have no CPU mode; they are
held against these plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tci_tpu_torch.ops import probe_batched as pb

torch.set_num_threads(1)


def _second_table(name, B):
    rng = np.random.default_rng(11)
    if name == "v4b":
        # halves: 2t and t + 1 are exact in float32
        return (rng.integers(-64, 64, size=(B, 2)) / 2).astype(np.float32)
    s = rng.integers(-50, 50, size=(B, 3)).astype(np.int32)
    if name in ("v4", "v4c"):
        s[:, 0] = [3, 0, 17, 1, 6][:B]  # the loop limits, one of them 0
    return s


def _inputs(name, which):
    """(B, n, table or None) of an input set."""
    if which == "probe":
        B, n = 4, 256
        s = None if name == "v1" else pb.probe_table(name, B, "cpu").numpy()
    else:
        B, n = 5, 40
        s = None if name == "v1" else _second_table(name, B)
    return B, n, s


def _call(fn, name, B, n, s):
    """Run wrapper or plain version `fn` of probe `name`; returns a dict
    of numpy outputs {"o": ..., "v": ...}."""
    if name == "v1":
        return {"o": fn(B, "cpu").numpy()}
    st = torch.from_numpy(s)
    if name == "v2":
        return {"o": fn(st).numpy()}
    v, o = fn(st, n)
    return {"v": v.numpy(), "o": o.numpy()}


def _closed_form(name, B, n, s):
    b = np.arange(B)
    if name == "v1":  # :48-51  o[b] = (b, b + 1)
        return {"o": np.stack([b, b + 1], 1)}
    s0 = s[:, 0]
    row = np.ones((B, 1, n), dtype=s.dtype)
    if name == "v2":  # :64-67  o[b] = (2 s[b, 0], s[b, 2])
        return {"o": np.stack([2 * s0, s[:, 2]], 1)}
    if name == "v3":  # :82-89  v[b, 0, :] = arange(n) + s[b, 0]
        return {"v": (np.arange(n)[None, :] + s0[:, None])[:, None, :],
                "o": np.stack([s0, b], 1)}
    lim = np.maximum(s0, 0)
    if name == "v4":  # :109-123  acc = sum of k < lim; o[b] = (acc, k)
        acc = lim * (lim - 1) // 2
        return {"v": row * acc[:, None, None], "o": np.stack([acc, lim], 1)}
    if name == "v4b":  # :144-149  v = 2 t; o[b] = (t + 1, t)
        return {"v": row * (2 * s0)[:, None, None],
                "o": np.stack([s0 + 1, s0], 1)}
    if name == "v4c":  # :169-182  v = lim after lim increments; o[b] = (k, b)
        return {"v": row * lim[:, None, None], "o": np.stack([lim, b], 1)}
    raise AssertionError(name)


def _pallas(name, B, n, s):
    """A copy of the probe's Pallas body, run by the Pallas interpreter."""
    i32, f32 = jnp.int32, jnp.float32
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    rowspec = pl.BlockSpec((None, 1, n), lambda b: (b, 0, 0),
                           memory_space=pltpu.VMEM)

    def v1(o_ref):
        b = pl.program_id(0)
        o_ref[b, 0] = b
        o_ref[b, 1] = b + 1

    def v2(s_ref, o_ref):
        b = pl.program_id(0)
        o_ref[b, 0] = s_ref[b, 0] * 2
        o_ref[b, 1] = s_ref[b, 2]

    def v3(s_ref, v_ref, o_ref):
        b = pl.program_id(0)
        v_ref[0] = (jax.lax.broadcasted_iota(i32, (n, 1), 0)[:, 0]
                    + s_ref[b, 0])
        o_ref[b, 0] = s_ref[b, 0]
        o_ref[b, 1] = b

    def v4(s_ref, v_ref, o_ref):
        b = pl.program_id(0)
        lim = s_ref[b, 0]
        k, acc = jax.lax.while_loop(
            lambda st: st[0] < lim, lambda st: (st[0] + 1, st[1] + st[0]),
            (i32(0), i32(0)))
        v_ref[0] = jnp.full((n,), acc, i32)
        o_ref[b, 0] = acc
        o_ref[b, 1] = k

    def v4b(s_ref, v_ref, o_ref):
        b = pl.program_id(0)
        t = s_ref[b, 0]
        v_ref[0] = jnp.full((n,), t * 2.0, f32)
        o_ref[b, 0] = t + 1.0
        o_ref[b, 1] = t

    def v4c(s_ref, v_ref, o_ref):
        b = pl.program_id(0)
        lim = s_ref[b, 0]
        v_ref[0] = jnp.zeros((n,), i32)

        def body(st):
            v_ref[0] = v_ref[0] + 1
            return (st[0] + 1,)

        (k,) = jax.lax.while_loop(lambda st: st[0] < lim, body, (i32(0),))
        o_ref[b, 0] = k
        o_ref[b, 1] = b

    dt = f32 if name == "v4b" else i32
    o_shape = jax.ShapeDtypeStruct((B, 2), dt)
    if name == "v1":
        return {"o": np.asarray(pl.pallas_call(
            v1, grid=(B,), out_shape=o_shape, out_specs=smem,
            interpret=True)())}
    if name == "v2":
        return {"o": np.asarray(pl.pallas_call(
            v2, grid=(B,), out_shape=o_shape, in_specs=[smem],
            out_specs=smem, interpret=True)(jnp.asarray(s)))}
    kern = {"v3": v3, "v4": v4, "v4b": v4b, "v4c": v4c}[name]
    v, o = pl.pallas_call(
        kern, grid=(B,),
        out_shape=(jax.ShapeDtypeStruct((B, 1, n), dt), o_shape),
        in_specs=[smem], out_specs=(rowspec, smem),
        interpret=True)(jnp.asarray(s))
    return {"v": np.asarray(v), "o": np.asarray(o)}


@pytest.mark.parametrize("which", ["probe", "second"])
@pytest.mark.parametrize("name", pb.NAMES)
def test_plain_matches_closed_form(name, which):
    B, n, s = _inputs(name, which)
    out = _call(pb.PROBES[name][1], name, B, n, s)
    ref = _closed_form(name, B, n, s)
    for key in ref:
        assert out[key].dtype == (np.float32 if name == "v4b" else np.int32)
        assert out[key].shape == ref[key].shape
        assert np.array_equal(out[key], ref[key])


@pytest.mark.parametrize("which", ["probe", "second"])
@pytest.mark.parametrize("name", pb.NAMES)
def test_plain_matches_pallas_interpreter(name, which):
    B, n, s = _inputs(name, which)
    out = _call(pb.PROBES[name][1], name, B, n, s)
    ref = _pallas(name, B, n, s)
    assert out.keys() == ref.keys()
    for key in ref:
        assert out[key].dtype == ref[key].dtype
        assert out[key].shape == ref[key].shape
        assert np.array_equal(out[key], ref[key])


@pytest.mark.parametrize("name", pb.NAMES)
def test_cpu_tensor_takes_the_plain_version(name):
    """On the CPU the dispatching wrapper returns the plain version's
    result and launches nothing; the kernel's launcher takes no CPU
    tensor."""
    B, n, s = _inputs(name, "second")
    launches = dict(pb.LAUNCHES)
    out = _call(pb.PROBES[name][0], name, B, n, s)
    ref = _call(pb.PROBES[name][1], name, B, n, s)
    for key in ref:
        assert np.array_equal(out[key], ref[key])
    assert dict(pb.LAUNCHES) == launches
    st = None if s is None else torch.from_numpy(s)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pb._launch(name, st, B, n, torch.device("cpu"), torch.int32, True)


@pytest.mark.parametrize("name", [n for n in pb.NAMES if n != "v1"])
def test_bad_table_raises(name):
    B, n, s = _inputs(name, "probe")
    wrapper = pb.PROBES[name][0]
    args = () if name == "v2" else (n,)
    wrong = torch.from_numpy(s).to(
        torch.int32 if name == "v4b" else torch.float32)
    with pytest.raises(ValueError, match="table"):
        wrapper(wrong, *args)
    with pytest.raises(ValueError, match="table"):
        wrapper(torch.from_numpy(s)[:, :1].contiguous(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(torch.from_numpy(np.concatenate([s, s], 1))[:, ::2][:, :3]
                if name != "v4b" else
                torch.from_numpy(np.concatenate([s, s], 1))[:, ::2], *args)
    if name != "v2":
        with pytest.raises(ValueError, match="n >= 1"):
            wrapper(torch.from_numpy(s), 0)


def test_run_probes_on_the_cpu():
    """The probe's JSON object: its keys, every step ok, and the values
    the probe prints (benchmarks/probe_pallas_batched.py:58-231)."""
    out = pb.run_probes("cpu")
    assert list(out) == [
        "v1_smem_dyn_store", "v2_smem_dyn_read", "v3_b1n_blocked_out",
        "v4_while_loop", "v4b_f32_smem", "v4c_row0_rmw_in_loop",
        "v5a_single_panel_64x128", "v5_batched_rrlu_small"]
    assert all(step["ok"] for step in out.values())
    checks = [step["check"] for step in out.values()]
    assert checks == [[0, 1, 2, 3], [0, 6, 12, 18], [0, 3, 6, 9],
                      [1, 3, 6, 10], [1.0, 3.0, 5.0, 7.0], [2, 3, 4, 5],
                      32, [32, 32, 32, 32]]


def test_run_probes_reports_a_failing_step(monkeypatch):
    def broken(s, n=256):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(pb, "v4", broken)
    out = pb.run_probes("cpu")
    assert out["v4_while_loop"] == {
        "ok": False, "error": "RuntimeError: kernel launch failed"}
    assert out["v4c_row0_rmw_in_loop"]["ok"]
