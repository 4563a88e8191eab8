"""Build and load the port's CUDA kernels: nvcc into ``build/``, ctypes to bind.

Each kernel source under ``kernels/<name>/csrc/`` is a CUDA C++ file with a
plain C interface. It is compiled for Hopper (``sm_90a``) into its own shared
library under ``build/`` at the repo root, named by a hash of the source and
the flags, and loaded with ``ctypes``: pointers and the stream travel as
``c_void_p``, and each C entry point returns ``cudaGetLastError()`` right
after its launch, which ``check`` turns into an exception.

Nothing is compiled when a module is imported. A wrapper's first launch
builds its library (``load``); ``build_all`` starts one nvcc per source, all
at once, and waits for them, which is how ``chip_smoke.py`` builds. The
libraries are built from the repo's sources only; ``build/`` is listed in
``.gitignore``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build"
KERNELS_DIR = Path(__file__).resolve().parent

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> its source, relative to this directory
SOURCES = {
    "segment_sum": "segment_sum/csrc/segment_sum.cu",
    "kcore_hindex": "kcore_hindex/csrc/kcore_hindex.cu",
    "flash_attention": "flash_attention/csrc/flash_attention.cu",
    "embedding_bag": "embedding_bag/csrc/embedding_bag.cu",
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# builds this process ran, and the wall they took (core/jit_telemetry.py reads
# them; KCoreResult.recompiles / compile_s report the delta a run caused)
_builds = 0
_build_seconds = 0.0


def build_count() -> int:
    return _builds


def build_seconds() -> float:
    return _build_seconds


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def _target(name: str) -> Path:
    src = KERNELS_DIR / SOURCES[name]
    h = hashlib.blake2b(digest_size=8)
    h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()}.so"


def ptxas_log(name: str) -> str:
    """The compiler's ``-Xptxas -v`` report for the library ``name`` (registers,
    shared memory, spills per kernel), or "" if it was not built yet."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names=None) -> dict[str, float]:
    """Compile every named kernel (default: all) whose library is missing.

    One nvcc per source, all started together. Returns the seconds each
    build took (0.0 where the library already existed). Raises
    ``RuntimeError`` with the compiler's output if any build fails.
    """
    global _builds, _build_seconds
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {name: 0.0 for name in names}
    started = {}
    t_wall = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(KERNELS_DIR / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    _builds += len(started)
    _build_seconds += sum(seconds.values())
    if started:
        from repro_torch.core import jit_telemetry

        jit_telemetry.record_build(started, time.perf_counter() - t_wall)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str, symbols: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.

    ``symbols`` maps each C entry point to its ctypes ``argtypes``; every
    entry point returns an ``int`` CUDA error code.
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _target(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            for sym, argtypes in symbols.items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
