"""Wrapper of the kcore_hindex kernel (``csrc/kcore_hindex.cu``).

``hindex_rows(nbr_est, est_u, n_iters)`` keeps the reference's signature
(``repro.kernels.kcore_hindex.ops.hindex_rows``): the rowwise clipped
h-index of an ELL tile of gathered neighbor estimates, found by exactly
``n_iters`` binary-search probes. On a CUDA tensor it launches the kernel
(or raises); on a CPU tensor it computes the plain version,
``ref.hindex_rows_ref``. ``launches`` counts the kernel's launches and
nothing else. Estimates must be non-negative, as k-core estimates are.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kcore_hindex.ref import hindex_rows_ref

launches = 0

_SYMBOLS = {
    "kcore_hindex_i32": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_void_p],
}

def _check(nbr_est: torch.Tensor, est_u: torch.Tensor, n_iters: int) -> None:
    if nbr_est.dtype != torch.int32 or nbr_est.dim() != 2 or not nbr_est.is_contiguous():
        raise ValueError(f"nbr_est must be a contiguous 2-D int32 tensor, got "
                         f"{nbr_est.dtype} {tuple(nbr_est.shape)}")
    if est_u.dtype != torch.int32 or est_u.shape != nbr_est.shape[:1] \
            or not est_u.is_contiguous():
        raise ValueError(f"est_u must be a contiguous int32 tensor of shape "
                         f"({nbr_est.shape[0]},), got {est_u.dtype} {tuple(est_u.shape)}")
    if nbr_est.device != est_u.device:
        raise ValueError(f"nbr_est on {nbr_est.device} but est_u on {est_u.device}")
    if not 0 <= int(n_iters) < 2**31:
        raise ValueError(f"n_iters must be a non-negative int32, got {n_iters}")
    if nbr_est.shape[1] >= 2**31:
        raise ValueError(f"row width {nbr_est.shape[1]} does not fit an int32")


def hindex_rows(nbr_est: torch.Tensor, est_u: torch.Tensor, n_iters: int) -> torch.Tensor:
    """nbr_est (R, W) int32 (sentinel slots 0), est_u (R,) int32 -> (R,) int32."""
    global launches
    _check(nbr_est, est_u, n_iters)
    if nbr_est.device.type == "cpu":
        return hindex_rows_ref(nbr_est, est_u, n_iters)
    if nbr_est.device.type != "cuda":
        raise ValueError(f"hindex_rows runs on cuda or cpu, not {nbr_est.device}")
    rows, width = nbr_est.shape
    out = torch.empty(rows, dtype=torch.int32, device=nbr_est.device)
    if rows == 0:
        return out
    lib = _build.load("kcore_hindex", _SYMBOLS)
    stream = torch.cuda.current_stream(nbr_est.device).cuda_stream
    err = lib.kcore_hindex_i32(nbr_est.data_ptr(), est_u.data_ptr(), out.data_ptr(),
                               rows, width, int(n_iters), stream)
    _build.check(lib, err, "kcore_hindex")
    launches += 1
    return out
