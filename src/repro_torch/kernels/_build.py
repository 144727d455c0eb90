"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, under ``build/repro_torch/``
at the repository root, and loaded with ``ctypes``. A library's file name
carries a hash of its source, of each ``csrc/`` header the source
includes (``#include "hopper.cuh"``) and of the flags, so an edited source
or header is rebuilt and an unchanged one is reused. Nothing is built when
this module is imported: ``load`` builds on first use, and ``build_all``
builds every source at once (one ``nvcc`` process per source, all started
together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# C signatures of the entry points, by library.
SIGNATURES = {
    "fingerprint": {
        "fp_chunks_launch": [_P, _I64, _I64, _P, _P],
    },
    "cdc": {
        "cdc_window_hashes_launch": [_P, _P, _P, _P, ctypes.c_int, _I64, _P, _P, _P],
        "cdc_cut_positions_launch": [
            _P, _P, _P, _P, _P, ctypes.c_int, _I64, _P, ctypes.c_uint32, _I64, _I64,
            _P, _P, _P, _P, _P, _P, _P,
        ],
    },
    "flash_attn": {
        "flash_attn_launch": [
            _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
            ctypes.POINTER(_I64), ctypes.c_float, ctypes.c_int, _I64, ctypes.c_int, _P,
        ],
    },
    "flash_attn_bwd": {
        "flash_attn_bwd_launch": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
            ctypes.POINTER(_I64), ctypes.c_float, ctypes.c_int, _I64, _I64, ctypes.c_int, ctypes.c_int, _P,
        ],
    },
    "adamw": {
        "adamw_sumsq_launch": [_P, _I64, ctypes.c_int, ctypes.c_int, _P, _P],
        "adamw_finish_launch": [_P, _I64, ctypes.c_float, _P, _P],
        "adamw_apply_launch": [
            _P, _P, _P, _P, _P, _I64, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float, _P,
        ],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each library built here,
# and the seconds from the start of its nvcc until its result was read.
ptxas_reports: dict[str, str] = {}
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where CUDA is installed")
    return found


def _source_bytes(name: str) -> bytes:
    """``csrc/<name>.cu`` followed by each ``csrc/`` header it includes."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = re.findall(rb'^#include "([^"]+)"', src, flags=re.M)
    return src + b"".join((CSRC / h.decode()).read_bytes() for h in headers)


def _lib_path(name: str) -> Path:
    tag = hashlib.sha1(_source_bytes(name) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen, float] | None:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, tmp, proc, t0


def _finish(name: str, job: tuple[Path, Path, subprocess.Popen, float]) -> None:
    out, tmp, proc, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    ptxas_reports[name] = log
    build_seconds[name] = time.perf_counter() - t0
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every kernel source that has no up-to-date library, in parallel."""
    jobs = {name: _start(name) for name in SIGNATURES}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    job = _start(name)
    if job is not None:
        _finish(name, job)
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
