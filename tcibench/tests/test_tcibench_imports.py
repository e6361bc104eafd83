"""Nothing the benchmark runs loads JAX or the JAX package (module names
compared by their whole top-level name: ``tci_tpu_torch`` begins with
``tci_tpu``), the reference loads nothing of the program, and the command
fails without a card or without the program."""

import ast
import json
import shutil
import subprocess
import sys
import types

import pytest
from tiny import SCAN_CELLS

from tcibench import core

REFERENCE = sorted((core.BENCH / "reference").glob("*.py"))


def test_forbidden_names_are_whole_top_level_names():
    assert core.FORBIDDEN == ("jax", "jaxlib", "flax", "tci_tpu")
    assert "tci_tpu_torch" not in core.forbidden_modules()


@pytest.mark.parametrize("cell", SCAN_CELLS)
def test_a_run_loads_no_jax_nor_the_jax_package(cell):
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(core.BENCH / 'tests')!r})\n"
        f"sys.path.insert(0, {str(core.ROOT)!r})\n"
        "from tiny import run_tiny\n"
        f"line, _ = run_tiny({cell!r}, seconds=0.5)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "tci_tpu_torch" in tops
    assert not tops & set(core.FORBIDDEN)


def test_a_loaded_jax_stops_the_run(tiny, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(core.ForbiddenModules, match="jax"):
        tiny("lorentz8d.scan", seconds=0.2)


def test_a_metric_file_that_loads_jax_stops_the_command(tmp_path):
    # a reader added as a new file, which imports JAX when it is loaded
    # after the window: the command exits 3 and prints no result
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.BENCH, tmp_path / "tcibench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    (tmp_path / "tcibench" / "metrics" / "toy.loads_jax.py").write_text(
        "import jax\n\n\ndef read(run):\n    return 1.0\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "toy.loads_jax", "unit": "s",
                               "better": "lower", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": [SCAN_CELLS[1]]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    # the look for a card passes, and the cell runs on the CPU at a tiny
    # size; the copy's tcibench comes first, the program from the checkout
    code = (
        "import functools, sys, torch\n"
        f"sys.path[:0] = [{str(stub.parent)!r}, "
        f"{str(tmp_path / 'tcibench' / 'tests')!r}, {str(tmp_path)!r}, "
        f"{str(core.ROOT)!r}]\n"
        "torch.cuda.is_available = lambda: True\n"
        "torch.cuda.device_count = lambda: 1\n"
        "from tiny import TINY\n"
        "from tcibench import core, run\n"
        "core.run_cell = functools.partial(core.run_cell, device='cpu', "
        "overrides=TINY['lorentz8d'])\n"
        f"sys.exit(run.main(['--workload', {SCAN_CELLS[1]!r}, '--seed', "
        "'2147483659', '--seconds', '0.5', '--trace', '0']))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 3, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert "jax" in out.stderr.splitlines()[-1]


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "numpy"}, names
    code = (f"import sys; sys.path.insert(0, {str(path.parent)!r}); "
            f"import {path.stem}; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout
    for name in ("tci_tpu_torch", "tci_tpu", "jax", "torch"):
        assert f"'{name}'" not in loaded


def test_command_fails_without_a_card_or_the_program(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the command would run the cell")
    # a directory with BENCHMARK.json and the benchmark's paths only
    spec = core.load_spec()
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    for p in spec["paths"]:
        shutil.copytree(core.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (core.ROOT, tmp_path):
        out = subprocess.run(
            [*spec["command"], "--workload", SCAN_CELLS[0], "--seed",
             str(2**31 + 3), "--seconds", "1", "--trace", "0"],
            capture_output=True, text=True, timeout=300, cwd=cwd)
        assert out.returncode != 0
        assert out.stdout.strip() == ""
