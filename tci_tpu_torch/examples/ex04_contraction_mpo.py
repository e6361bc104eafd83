"""MPO x MPO contraction with all three algorithms (contraction.jl).

Builds two random MPOs, contracts them with naive (exact Kronecker merge
then compression), zipup (streaming contract + factorize) and TCI (the
product treated as a lazy function and cross-interpolated once more), and
checks all three against the dense matrix product. ``torch_native=True``
moves each algorithm onto the device tiers.
"""

import numpy as np

import tci_tpu_torch as tci
from tci_tpu_torch.examples import device_arg
from tci_tpu_torch.models.tensortrain import TensorTrain, fulltensor

L = 5


def rand_mpo(rng, chi, d1, d2, device):
    bonds = [1] + [chi] * (L - 1) + [1]
    return TensorTrain([
        rng.standard_normal((bonds[n], d1, d2, bonds[n + 1])) / np.sqrt(chi)
        for n in range(L)
    ], device=device)


def as_matrix(tt, rows, cols):
    """The MPO's full tensor, its up legs as rows and down legs as columns."""
    return fulltensor(tt).cpu().numpy().transpose(
        [2 * i for i in range(L)] + [2 * i + 1 for i in range(L)]
    ).reshape(rows, cols)


def main(argv=None):
    device = device_arg(__doc__.splitlines()[0], argv)
    rng = np.random.default_rng(42)
    A = rand_mpo(rng, 4, 2, 3, device)
    B = rand_mpo(rng, 3, 3, 2, device)

    # dense oracle: flatten the MPOs to matrices and multiply
    dense = as_matrix(A, 2**L, 3**L) @ as_matrix(B, 3**L, 2**L)

    for algorithm in ("naive", "zipup", "TCI"):
        for torch_native in (False, True):
            C = tci.contract(
                A, B, algorithm=algorithm, tolerance=1e-10, method="LU",
                torch_native=torch_native,
            )
            fC = as_matrix(C, 2**L, 2**L)
            err = np.abs(fC - dense).max() / np.abs(dense).max()
            tier = "device" if torch_native else "host"
            print(f"{algorithm:6s} ({tier:6s}): link dims {C.linkdims()}, "
                  f"rel err {err:.2e}")
            assert err < 1e-7
    print("ok")


if __name__ == "__main__":
    main()
