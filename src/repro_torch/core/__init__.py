"""The paper's primary contribution, ported: distributed k-core
decomposition in PyTorch with exact message accounting, the BZ oracle and
the simulated-network cost model.

Submodules are imported where they are used; this package imports nothing
on its own, so ``import repro_torch.core`` stays cheap and device-free.
"""
