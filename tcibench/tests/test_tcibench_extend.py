"""A configuration, a traffic mix and a per-layer metric are added as new
files and entries of BENCHMARK.json, and the harness finds them by name:
no file that was there is edited."""

import hashlib
import json
import shutil
import time

import pytest
from tiny import TINY

from tcibench import core

CONFIG = {
    "name": "toy3", "valuetype": "float64", "control_valuetype": "float32",
    "ndim": 3, "localdim": 4, "tolerance": 1e-10,
    "parameter": {"name": "c", "published": 1.0, "low": 1.0, "high": 2.0},
    "limits": {"grid_max_err": 1e-8},
}
SOLVER = '''
import numpy as np
import torch
from tci_tpu_torch.models import tensorci2
from tci_tpu_torch.parallel.batcheval import TorchBatchEvaluator


class Solver:
    def __init__(self, cfg, mix, device, valuetype):
        self.dims = [cfg["localdim"]] * cfg["ndim"]
        self.c = torch.zeros((), dtype=torch.float64, device=device)
        c = self.c
        self.ev = TorchBatchEvaluator(
            lambda idx: 1.0 / (c + idx.to(torch.float64).sum(1)), self.dims,
            device=device)
        self.cfg, self.device, self.valuetype = cfg, device, valuetype

    def solve(self, c, rng):
        self.c.fill_(c)
        return tensorci2.crossinterpolate2(
            self.valuetype, self.ev, self.dims,
            tolerance=self.cfg["tolerance"], device=self.device, rng=rng)[0]

    def evaluator(self):
        return self.ev

    @staticmethod
    def to_host(answer):
        return [t.numpy() for t in answer.sitetensors()]
'''
REFERENCE = '''
import itertools
import numpy as np


def judge(cfg, answers, seed):
    worst = 0.0
    grid = np.array(list(itertools.product(range(cfg["localdim"]),
                                           repeat=cfg["ndim"])))
    for c, cores in answers:
        v = cores[0][0][grid[:, 0], :]
        for s in range(1, cfg["ndim"]):
            v = np.einsum("nr,rns->ns", v, cores[s][:, grid[:, s], :])
        worst = max(worst, np.abs(v[:, 0] - 1.0 / (c + grid.sum(1))).max())
    return {"grid_max_err": worst}
'''
METRIC = '''
def read(run):
    return max(s.wall_s for s in run.solves) * 1e3 if run.solves else None
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.BENCH, tmp_path / "tcibench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "tcibench"
    before = _digests(bench)

    (bench / "configs" / "toy3.json").write_text(json.dumps(CONFIG))
    (bench / "configs" / "toy3.py").write_text(SOLVER)
    (bench / "reference" / "toy3.py").write_text(REFERENCE)
    (bench / "traffic" / "burst.json").write_text(
        json.dumps({"closure": "kept"}))
    (bench / "metrics" / "toy.max_wall_ms.py").write_text(METRIC)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy3", "source": "a test", "reduced": [],
                            "file": "tcibench/configs/toy3.json",
                            "why": "a test"})
    spec["workloads"].append({"name": "toy3.burst", "config": "toy3",
                              "traffic": "burst", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "toy.max_wall_ms", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "test", "moves": "solves_per_s",
                              "workloads": ["toy3.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    for trace in (False, True):
        line, checks = core.run_cell("toy3.burst", 7, 0.5, trace,
                                     time.perf_counter(), device="cpu",
                                     root=tmp_path)
        assert line["correct"] is True, checks
        assert line["checks"]["grid_max_err"]["value"] <= 1e-8
    assert set(line["metrics"]) >= {"toy.max_wall_ms"}
    after = _digests(bench)
    assert all(after[p] == d for p, d in before.items())
    assert set(after) - set(before) == {
        p.relative_to(bench) for p in (
            bench / "configs" / "toy3.json", bench / "configs" / "toy3.py",
            bench / "reference" / "toy3.py", bench / "traffic" / "burst.json",
            bench / "metrics" / "toy.max_wall_ms.py")}


@pytest.mark.parametrize("config", ["gk15_10d", "lorentz8d"])
def test_a_fresh_cell_needs_only_its_entry(tmp_path, config):
    # traffic/fresh.json is in the tree for the fresh cells kept for a later
    # benchmark PR: a new function (the parameter baked in as a float) and
    # a new evaluator each solve
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.BENCH, tmp_path / "tcibench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "tcibench")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": f"{config}.fresh", "config": config,
                              "traffic": "fresh", "chips": 1,
                              "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    line, checks = core.run_cell(f"{config}.fresh", 2**31 + 7, 1.0, False,
                                 time.perf_counter(), device="cpu",
                                 overrides=TINY[config], root=tmp_path)
    assert line["correct"] is True and line["failed"] == 0, checks
    assert _digests(tmp_path / "tcibench") == before
