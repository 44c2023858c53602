"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device.  This file
imports no jax, so it also runs on a machine with the card and without
jax (``--noconftest`` skips the JAX settings of ``tests/conftest.py``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from presto_tpu_torch.ops import cuda_kernels as CK
from presto_tpu_torch.ops import hashtable as HT


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    CK.build()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [0, 1, 8191, 1 << 20])
def test_masked_sum_equals_plain(card, size):
    rng = np.random.default_rng(size)
    v = torch.from_numpy(rng.integers(-2**62, 2**62, size=size))
    m = torch.from_numpy(rng.random(size) < 0.4)
    before = CK.LAUNCHES["masked_sum"]
    got = CK.masked_sum(v.to(card), m.to(card))
    torch.cuda.synchronize()
    assert int(got) == int(CK.masked_sum_plain(v, m))
    assert CK.LAUNCHES["masked_sum"] == before + (size > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [500, 317, 0])
def test_sorted_probe_equals_plain(card, n_valid):
    rng = np.random.default_rng(n_valid)
    keys = np.sort(rng.integers(-10**12, 10**12, size=500))
    keys[n_valid:] = rng.integers(-10**12, 10**12, size=500 - n_valid)
    probe = np.concatenate([rng.choice(keys, 300),
                            rng.integers(-2 * 10**12, 2 * 10**12, 300),
                            [-2**63, 2**63 - 1]]).astype(np.int64)
    keys, probe = torch.from_numpy(keys), torch.from_numpy(probe)
    got = CK.sorted_probe(keys.to(card), probe.to(card),
                          torch.tensor(n_valid, device=card))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        got.cpu().numpy(), CK.sorted_probe_plain(keys, probe, n_valid).numpy())


@pytest.mark.cuda
def test_lookup_on_card_launches_sorted_probe(card):
    """A single-key lookup of a table on the card goes through the kernel
    and equals the same lookup on the CPU."""
    rng = np.random.default_rng(9)
    build = torch.from_numpy(rng.choice(10**6, 50_000, replace=False))
    probe = torch.from_numpy(rng.integers(0, 10**6, 200_000))
    mask = torch.from_numpy(rng.random(200_000) < 0.9)
    want = HT.lookup(HT.build([build], torch.ones(50_000, dtype=torch.bool),
                              HT.capacity_for(50_000)), [probe], mask)
    table = HT.build([build.to(card)],
                     torch.ones(50_000, dtype=torch.bool, device=card),
                     HT.capacity_for(50_000))
    before = CK.LAUNCHES["sorted_probe"]
    got = HT.lookup(table, [probe.to(card)], mask.to(card))
    assert CK.LAUNCHES["sorted_probe"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
