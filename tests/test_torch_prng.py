"""The port's threefry2x32 (tci_tpu_torch/utils/prng.py) against jax.random,
bit for bit, on the CPU.

The whole-sweep rook of tci_tpu fills each bond's start set from
``jax.random.uniform(fold_in(PRNGKey(seed), b), (n,))`` in float64; the
port must draw the same numbers to pick the same pivots. Tolerance: none,
every key word and every draw identical (the float64 draws compared as
their bits).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tci_tpu_torch.utils import prng

SEEDS = [0, 1, 7, 12345, 987654321, 2**31 - 2]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_uniform_match_jax(seed):
    key = jax.random.PRNGKey(jnp.uint32(seed))
    tkey = prng.prng_key(torch.tensor(seed))
    assert np.asarray(key).astype(np.int64).tolist() == tkey.tolist()
    for b in (0, 1, 6, 39):
        kb = jax.random.fold_in(key, jnp.int32(b))
        tkb = prng.fold_in(tkey, b)
        assert np.asarray(kb).astype(np.int64).tolist() == tkb.tolist()
        for n in (1, 7, 352, 1024):
            u = np.asarray(jax.random.uniform(kb, (n,), dtype=jnp.float64))
            tu = prng.uniform_f64(tkb, n).numpy()
            np.testing.assert_array_equal(u.view(np.int64),
                                          tu.view(np.int64))
            assert ((tu >= 0.0) & (tu < 1.0)).all()


def test_threefry_known_answer():
    """The Random123 known-answer vector of threefry2x32 (20 rounds): key
    and counter all ones in every bit."""
    ones = torch.tensor(0xFFFFFFFF)
    y0, y1 = prng.threefry2x32(ones, ones, ones, ones)
    assert (int(y0), int(y1)) == (0x1CB996FC, 0xBB002BE7)
    z = torch.tensor(0)
    y0, y1 = prng.threefry2x32(z, z, z, z)
    assert (int(y0), int(y1)) == (0x6B200159, 0x99BA4EFE)


def test_seed_as_device_tensor_broadcasts():
    """The engine hands the seed over as a 0-d tensor of its record and the
    counters as a vector: the same words as scalar calls."""
    seed = torch.tensor(424242)
    key = prng.fold_in(prng.prng_key(seed), 3)
    many = prng.uniform_f64(key, 5)
    one = torch.stack([prng.uniform_f64(key, i + 1)[i] for i in range(5)])
    assert torch.equal(many, one)
