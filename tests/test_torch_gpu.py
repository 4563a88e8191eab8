"""The port on the card: each CUDA kernel against its plain version, and the
decomposition through both kernels.

Every test here is marked ``gpu`` and skips where no CUDA device is present;
the file imports neither ``jax`` nor the reference, so it runs on a machine
with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.bz import bz_core_numbers
from repro_torch.core.kcore import kcore_decompose
from repro_torch.graph import generators
from repro_torch.kernels.kcore_hindex import ops as hk
from repro_torch.kernels.segment_sum import ops as sk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.parametrize("rows,width,n_iters", [
    (1, 8, 13), (1001, 8, 13), (130, 17, 13), (77, 2048, 13), (5, 2049, 13),
    (3, 20000, 16), (64, 32, 3)])
def test_hindex_kernel_matches_plain(cuda, rows, width, n_iters):
    r = np.random.default_rng(rows + width)
    nbr = torch.as_tensor(r.integers(0, 3000, (rows, width)).astype(np.int32), device=cuda)
    est = torch.as_tensor(r.integers(0, 3000, rows).astype(np.int32), device=cuda)
    before = hk.launches
    got = hk.hindex_rows(nbr, est, n_iters)
    torch.cuda.synchronize()
    assert hk.launches == before + 1
    assert torch.equal(got, hk.hindex_rows_ref(nbr, est, n_iters))


@pytest.mark.parametrize("E,n", [(1, 17), (33, 1), (100_001, 70_000), (1_000_000, 3)])
def test_segment_sum_kernel_matches_plain(cuda, E, n):
    r = np.random.default_rng(E)
    layout = sk.csr_layout(np.sort(r.integers(0, n, E)), n)
    vals = torch.as_tensor(r.integers(-2**31, 2**31, E).astype(np.int32), device=cuda)
    row_ptr = torch.as_tensor(layout.row_ptr, device=cuda)
    before = sk.launches
    got = sk.segment_sum(vals, row_ptr)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    assert torch.equal(got, sk.segment_sum_ref(vals, row_ptr))


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
def test_decomposition_on_the_card_runs_both_kernels(cuda, fused):
    g = generators.snap_analogue("EEN", 0.05, seed=0)
    hk.launches = sk.launches = 0
    res = kcore_decompose(g, fused=fused)
    assert res.dispatch == "kernel"
    assert hk.launches > 0 and sk.launches > 0
    np.testing.assert_array_equal(res.core, bz_core_numbers(g))
    cpu = kcore_decompose(g, fused=fused, device="cpu")
    assert res.rounds == cpu.rounds
    np.testing.assert_array_equal(res.stats.messages_per_round, cpu.stats.messages_per_round)
