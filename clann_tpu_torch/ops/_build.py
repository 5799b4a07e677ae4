"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, on first use, under
``build/kernels/`` at the repository root (listed in ``.gitignore``). The
library name carries a hash of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded. The library is bound with
``ctypes``: pointers and the stream are ``c_void_p``, so 64-bit values are
never cut to 32 bits.

Nothing here runs at import time, and there is no fallback: a missing
``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LIB: Optional[ctypes.CDLL] = None
# nvcc's -Xptxas -v summary of the last build made by this process
# (registers, shared memory, spills per kernel); empty when the library
# was already built.
PTXAS_INFO: List[str] = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH or CUDA_HOME/bin): the CUDA kernels of "
        "clann_tpu_torch are built from source on first use"
    )


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libclann_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    PTXAS_INFO[:] = [
        ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
        if "spill" in ln or ("ptxas info" in ln and (
            "Used" in ln or "Compiling entry" in ln))
    ]
    print("\n".join(PTXAS_INFO), flush=True)
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' shared library (built on first call), with argtypes."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.clann_scan_topk_packed.argtypes = [vp, vp, vp, i64, i32, i32, i32, i32, i32, vp]
    lib.clann_scan_topk_packed.restype = i32
    lib.clann_cuda_error_string.argtypes = [i32]
    lib.clann_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if code != 0:
        msg = lib.clann_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
