"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into one shared library with a
plain C interface, on first use, under ``build/kernels/`` at the repository
root (listed in ``.gitignore``). The
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
import threading
from pathlib import Path
from typing import List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LIB: Optional[ctypes.CDLL] = None
_LOAD_LOCK = threading.Lock()  # one build and load, whichever thread comes first
# Guards the wrappers' launch counts: the single controller launches from
# one worker thread per card (parallel/mesh.run_shards), and `X += 1` on a
# module global is not atomic across threads.
COUNT_LOCK = threading.Lock()
# nvcc's -Xptxas -v summary of the last build made by this process
# (registers, shared memory, spills per kernel, and ptxas' warnings, e.g. a
# serialised wgmma or an ignored setmaxnreg); empty when the library was
# already built.
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


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Run the commands in parallel; their output, or raise if one failed
    (after every one has ended)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, text in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{text}")
    return outs


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [out.with_suffix(f".{src.stem}.{os.getpid()}.o") for src in _sources()]
    try:
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                         for o, src in zip(objs, _sources())])
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    PTXAS_INFO[:] = [
        ln.strip() for ln in "".join(logs).splitlines()
        if "spill" in ln or "warning" in ln or "Performance" in ln or (
            "ptxas info" in ln and ("Used" in ln or "Compiling entry" in ln))
    ]
    print("\n".join(PTXAS_INFO), flush=True)
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' shared library (built on first call), with argtypes."""
    if _LIB is not None:
        return _LIB
    with _LOAD_LOCK:
        return _LIB if _LIB is not None else _load()


def _load() -> ctypes.CDLL:
    global _LIB
    lib = ctypes.CDLL(str(build()))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.clann_scan_topk_packed.argtypes = [
        vp, vp, vp, i64, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.clann_scan_topk_packed.restype = i32
    lib.clann_scan_candidates.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32, vp]
    lib.clann_scan_candidates.restype = i32
    lib.clann_block_scan_packed.argtypes = [
        vp, vp, vp, vp, vp, i64, i64, i32, i64, i32, i32, i32, vp]
    lib.clann_block_scan_packed.restype = i32
    lib.clann_gather_pages.argtypes = [vp, i64, vp, i64, vp, i32, i32, vp]
    lib.clann_gather_group8.argtypes = [vp, i64, i32, vp, i64, vp, i32, i32, vp]
    lib.clann_gather_warp.argtypes = [vp, i64, vp, i64, vp, i64, vp]
    for fn in (lib.clann_gather_pages, lib.clann_gather_group8, lib.clann_gather_warp):
        fn.restype = i32
    lib.clann_window_filter.argtypes = [
        vp, i32, i64, i32, i32, vp, i32, i32, vp, vp, vp, i32, i32, vp, i32, vp, vp, i32, i32,
        vp, i32, i32, vp, i32, i32, i32, vp]
    lib.clann_window_filter.restype = i32
    lib.clann_score_merge.argtypes = [
        vp, i64, i32, i32, vp, vp, vp, vp, i32, i32, i32, i32, vp, vp, i32, i32, i32, vp]
    lib.clann_score_merge.restype = i32
    lib.clann_cuda_error_string.argtypes = [i32]
    lib.clann_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if code != 0:
        msg = lib.clann_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
