"""The examples of tci_tpu_torch (``tci_tpu_torch/examples``) run end to
end on the CPU, each as ``python -m ... --device cpu`` in a process of its
own, and end by printing ``ok`` after their own asserts. The 10-D
integration (ex03, BASELINE config 4 on the host and the device path) costs
more than the others on the CPU and runs on the card only, in
``chip_smoke.py``'s phase 4k."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("example", [
    "ex01_quickstart_lorentzian", "ex02_quantics_oscillatory",
    "ex04_contraction_mpo", "ex05_complex_feynman", "ex07_checkpoint_resume"])
def test_example_runs_on_the_cpu(example):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", f"tci_tpu_torch.examples.{example}",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[-1] == "ok"


def test_example_without_a_card_raises():
    """An example's default device is the card: on a host without one it
    fails, naming device="cpu"."""
    code = ("import torch; torch.cuda.is_available = lambda: False\n"
            "from tci_tpu_torch.examples import ex07_checkpoint_resume as e\n"
            "e.main([])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert 'device="cpu"' in proc.stderr
