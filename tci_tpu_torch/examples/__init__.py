"""Examples of tci_tpu_torch, the counterparts of ``examples/01-07`` of
``tci_tpu``. Run one from the repository root on the card, or on the CPU
with ``--device cpu``:

    python -m tci_tpu_torch.examples.ex01_quickstart_lorentzian [--device cpu]

ex06, the multi-GPU mesh, runs one process a rank (its docstring says
how).

Each runs its counterpart's workload at its size, checks it with the same
asserts and ends by printing ``ok``.
"""

import argparse


def device_arg(description: str, argv=None):
    """Parse the examples' one option, ``--device`` (default: the current
    CUDA device; the entry points raise without one unless it is
    ``cpu``)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default=None,
                        help='torch device to run on (default: the current '
                        'CUDA device; "cpu" for the CPU)')
    return parser.parse_args(argv).device
