"""The check that decides ``correct`` fails where it has to: a parameter
baked into the function, the lower-precision control, and the timed path
broken underneath (a step that leaves the state unchanged, half of each
batch left out, an answer altered where it is produced). One chip: no
exchange between chips to leave out. Tiny sizes on the CPU."""

import json
import subprocess

import pytest
import torch
from tiny import SCAN_CELLS


def _assert_incorrect(line):
    assert line["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in line["checks"].values()) or line["failed"]


@pytest.mark.parametrize("cell", SCAN_CELLS)
def test_parameter_baked_in_as_a_float_is_judged_incorrect(tiny, cell,
                                                           monkeypatch):
    # what a CUDA graph does to a Python float that f closes over: every
    # solve sees the value the closure was built with
    from tcibench import core
    config = cell.split(".")[0]
    mod = core.load_module(core.BENCH / "configs" / f"{config}.py",
                           f"tcibench_config_{config}")
    family = "integrand" if config == "gk15_10d" else "function"
    orig = getattr(mod, family)

    def baked(param, *args):
        return orig(float(param), *args)

    real_load = core.load_module

    def load(path, name):
        if path.name == f"{config}.py" and path.parent.name == "configs":
            monkeypatch.setattr(mod, family, baked)
            return mod
        return real_load(path, name)

    monkeypatch.setattr(core, "load_module", load)
    line, _ = tiny(cell, seconds=2.0)
    assert line["failed"] == 0
    _assert_incorrect(line)


def test_lower_precision_control_fails(tiny):
    # lorentz8d's float32 control reads ~1e-7 at up to 8 sites of 4 on a
    # CPU, below its limit; it fails at its own size (~1e-6), which the
    # card's test below runs
    line, _ = tiny("gk15_10d.scan", seconds=2.0, control=True)
    _assert_incorrect(line)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", SCAN_CELLS)
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_lower_precision_control_fails_on_the_card(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tcibench import core
    spec = core.load_spec()
    out = subprocess.run(
        [*spec["command"], "--workload", cell, "--seed", str(seed),
         "--seconds", "5", "--trace", "0", "--control"],
        capture_output=True, text=True, timeout=900, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    _assert_incorrect(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", SCAN_CELLS)
def test_cell_is_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tcibench import core
    spec = core.load_spec()
    out = subprocess.run(
        [*spec["command"], "--workload", cell, "--seed", str(2**31 + 104),
         "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"


def _state_unchanged(monkeypatch):
    from tci_tpu_torch.models import tensorci2

    def optimize(self, f, **kwargs):
        # no sweep: the state TCI2 started from, made into site tensors
        self.fillsitetensors(f)
        self.stats = {"nglobalpivots": [0]}
        return [self.rank()], [1.0]
    monkeypatch.setattr(tensorci2.TensorCI2, "optimize", optimize)


def _half_batch(monkeypatch):
    # every other row of each batch f evaluates left out and given the mean
    # of the rest (the engine's panels put their valid rows first and pad
    # the end, so the second half of a batch is mostly padding)
    from tci_tpu_torch.parallel.batcheval import TorchBatchEvaluator
    values = TorchBatchEvaluator._values

    def halved(self):
        g = values.fget(self)

        def f(indices):
            v = g(indices).clone()
            if v.shape[0] > 1:
                v[1::2] = v[0::2].mean()
            return v
        return f
    monkeypatch.setattr(TorchBatchEvaluator, "_values", property(halved))


def _answer_altered(monkeypatch):
    from tci_tpu_torch.models import tensorci2, tensortrain
    tt_sum = tensortrain.AbstractTensorTrain.sum
    optimize = tensorci2.TensorCI2.optimize

    def altered_sum(self):
        return tt_sum(self) * (1 + 1e-3)

    def altered_optimize(self, *args, **kwargs):
        out = optimize(self, *args, **kwargs)
        self._sitetensors[0] = self._sitetensors[0] * (1 + 1e-3)
        return out
    monkeypatch.setattr(tensortrain.AbstractTensorTrain, "sum", altered_sum)
    monkeypatch.setattr(tensorci2.TensorCI2, "optimize", altered_optimize)


@pytest.mark.parametrize("cell", SCAN_CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered])
def test_broken_timed_path_is_judged_incorrect(tiny, cell, fault,
                                               monkeypatch):
    fault(monkeypatch)
    line, _ = tiny(cell, seconds=1.0)
    _assert_incorrect(line)
