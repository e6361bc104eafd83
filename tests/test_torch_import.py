"""Import boundaries and placement rules of tci_tpu_torch, on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tci_tpu_torch.ops import _build, lu_cuda, lu_kernel

REPO = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def test_import_leaves_jax_out():
    code = (
        "import sys, tci_tpu_torch\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tci_tpu' or m.startswith('tci_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# tci_tpu's public names that the port does not have, each with the reason
# (JaxBatchEvaluator's scalar-f contract is TorchBatchEvaluator.from_scalar)
NOT_PORTED = {
    "replaced by TorchBatchEvaluator": {"JaxBatchEvaluator"},
}


def test_exports_cover_tci_tpu():
    """Every public name of tci_tpu is exported by the port, apart from the
    names ROADMAP assigns to later steps; every exported name exists."""
    import tci_tpu
    import tci_tpu_torch

    missing = set(tci_tpu.__all__) - set(tci_tpu_torch.__all__)
    assert missing == set().union(*NOT_PORTED.values())
    assert set(tci_tpu_torch.__all__) - set(tci_tpu.__all__) == {
        "TorchBatchEvaluator"}
    for name in tci_tpu_torch.__all__:
        assert getattr(tci_tpu_torch, name) is not None


@pytest.mark.parametrize("module", [
    "utils.quantics", "ops.kronrod", "ops.probe_batched",
    "models.integration", "ops.factorize", "models.ttcache",
    "models.globalsearch", "parallel.cachedfunction", "ops.lu_device",
    "utils.prng", "models.contraction", "models.contraction_device",
    "models.compress_device", "ops.ci", "ops.aca", "models.tensorci1",
    "models.conversion", "utils.checkpoint", "interop", "interop.mps",
    "examples", "examples.ex01_quickstart_lorentzian",
    "examples.ex02_quantics_oscillatory", "examples.ex03_integration_10d",
    "examples.ex04_contraction_mpo", "examples.ex05_complex_feynman",
    "examples.ex07_checkpoint_resume", "parallel.mesh", "parallel.dryrun",
    "ops.lu_sharded", "examples.ex06_multichip_mesh"])
def test_module_import_leaves_jax_out(module):
    code = (
        f"import sys, tci_tpu_torch.{module}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tci_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cpu_panel_takes_plain_version():
    A = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 16)))
    launches = lu_cuda.LAUNCHES["rrlu"]
    plain = lu_kernel.PLAIN_CALLS["cpu"]
    out = lu_kernel.rrlu_panel(A, 12, 14, 10, 1e-6, 0.0, leftorthogonal=True)
    ref = lu_kernel.rrlu_plain(A, 12, 14, 10, 1e-6, 0.0, leftorthogonal=True)
    assert lu_cuda.LAUNCHES["rrlu"] == launches
    assert lu_kernel.PLAIN_CALLS["cpu"] == plain + 2
    for o, r in zip(out, ref):
        assert torch.equal(o, r) or (o.isnan().all() and r.isnan().all())
    # the kernel's own wrapper takes no CPU tensor
    with pytest.raises(ValueError, match="CUDA tensor"):
        lu_cuda.rrlu_call(A, 12, 14, 10, 1e-6, 0.0, leftorthogonal=True)


def test_non_cuda_non_cpu_panel_raises():
    A = torch.empty((8, 8), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        lu_kernel.rrlu_panel(A, 8, 8, 8, 0.0, 0.0, leftorthogonal=True)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    CUDA device, in the repository and copied alone into an empty
    directory."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes((REPO / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
