"""ctypes bindings for the native reference-format codec (PyTorch port of
``clann_tpu.io.refcodec``).

Python side of ``clann_tpu_torch/native/codec.cpp``, the port's own copy
of the JAX package's codec source (byte for byte), the native equivalent
of the reference FFI shim (libpuffinn-ffi/c_binder.{h,cpp}): it translates
between the reference's versioned binary index stream and numpy arrays.
Host work only; nothing here touches torch.

The shared library is built with g++ (the JAX package's Makefile flags)
on first use into ``build/codec/`` at the repository root (git-ignored);
its name carries a hash of the source and flags, so an edited source is
rebuilt and a stale library is never loaded. A failed build raises
SerializeError with the compiler's output.

Interop surface:
- `parse_reference_stream(buf)` — read an index blob produced by the
  Rust/C++ reference (the "index_{i}" HDF5 datasets, c_binder.cpp:106-146)
  into arrays: Q15 vectors, sketches, hash-function parameters, per-table
  sorted (hash, index) arrays.
- `write_reference_stream(...)`, `write_reference_stream_fhtcp(...)`,
  `write_reference_stream_v2(d)` — emit streams the reference can load.
- Q15 <-> f32 conversion matching format/unit_vector.hpp:26-45.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from clann_tpu_torch.errors import SerializeError

CODEC_SOURCE = Path(__file__).resolve().parent.parent / "native" / "codec.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "codec"
# clann_tpu/native/Makefile's CXXFLAGS and link step
CXX_FLAGS = ["-std=c++17", "-O2", "-fPIC", "-Wall", "-Wextra", "-shared"]

FAMILY_SIMHASH = 0
FAMILY_FHT_CROSS_POLYTOPE = 1
FAMILY_CROSS_POLYTOPE = 2  # vanilla CP (crosspolytope.hpp:313-469)
FAMILY_MINHASH = 3  # Jaccard (minhash.hpp:97-220)
FAMILY_MINHASH_1BIT = 4

SOURCE_INDEPENDENT = 0  # HashSourceType (hash_source.hpp:6-10)
SOURCE_POOL = 1
SOURCE_TENSOR = 2

_lib: Optional[ctypes.CDLL] = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i8p = ctypes.POINTER(ctypes.c_int8)
_i16p = ctypes.POINTER(ctypes.c_int16)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_f32p = ctypes.POINTER(ctypes.c_float)


class RefWriteSpec(ctypes.Structure):
    """Mirror of codec.cpp's RefWriteSpec — field order/types must match."""

    _fields_ = [
        ("family", ctypes.c_uint32),
        ("source_kind", ctypes.c_uint32),
        ("dims", ctypes.c_uint32),
        ("storage_len", ctypes.c_uint32),
        ("n", ctypes.c_uint32),
        ("_pad0", ctypes.c_uint32),
        ("unit_data", _i16p),
        ("set_lens", _u64p),
        ("set_tokens", _u32p),
        ("num_rotations", ctypes.c_int32),
        ("est_reps", ctypes.c_uint32),
        ("est_eps", ctypes.c_float),
        ("mh_rand_bits", ctypes.c_uint32),
        ("mh_set_size", ctypes.c_uint32),
        ("pool_size", ctypes.c_uint32),
        ("estimates", _f32p),
        ("est_rows", ctypes.c_uint32),
        ("est_cols", ctypes.c_uint32),
        ("num_hash_fns", ctypes.c_uint32),
        ("_pad1", ctypes.c_uint32),
        ("planes", _i16p),
        ("signs", _i8p),
        ("log_dims", ctypes.c_int32),
        ("rotations", ctypes.c_uint32),
        ("cp_matrices", _i16p),
        ("mh_tabs", _u64p),
        ("mh_perm_bits", _u32p),
        ("mh_perm_lens", _u64p),
        ("mh_perms", _u32p),
        ("num_hashers", ctypes.c_uint32),
        ("functions_per_hasher", ctypes.c_uint32),
        ("bits_per_function", ctypes.c_uint32),
        ("next_function", ctypes.c_uint32),
        ("bits_to_cut", ctypes.c_uint32),
        ("pool_num_tables", ctypes.c_uint32),
        ("pool_index_lens", _u64p),
        ("pool_indices", _u32p),
        ("pool_bits_per_hasher", ctypes.c_uint32),
        ("pool_sampling_rep", ctypes.c_uint32),
        ("pool_bits_to_cut", ctypes.c_uint32),
        ("tens_num_hashers", ctypes.c_uint32),
        ("tens_next_idx", ctypes.c_uint32),
        ("tens_num_bits", ctypes.c_uint32),
        ("_pad2", ctypes.c_uint32),
        ("num_sketch_fns", ctypes.c_uint32),
        ("sk_mh_rand_bits", ctypes.c_uint32),
        ("sk_mh_set_size", ctypes.c_uint32),
        ("_pad3", ctypes.c_uint32),
        ("sketch_planes", _i16p),
        ("sk_mh_tabs", _u64p),
        ("sk_mh_perm_bits", _u32p),
        ("sk_mh_perm_lens", _u64p),
        ("sk_mh_perms", _u32p),
        ("sketch_hashers", ctypes.c_uint32),
        ("sketch_fph", ctypes.c_uint32),
        ("sketch_bits_per_function", ctypes.c_uint32),
        ("sketch_cut", ctypes.c_uint32),
        ("sketches", _u64p),
        ("num_sketch_words", ctypes.c_uint64),
        ("num_maps", ctypes.c_uint32),
        ("use_chunks", ctypes.c_uint32),
        ("map_lens", _u64p),
        ("map_indices", _u32p),
        ("map_hashes", _u32p),
        ("last_rebuild", ctypes.c_uint32),
        ("_pad4", ctypes.c_uint32),
    ]


def q15_to_f32(x: np.ndarray) -> np.ndarray:
    """Fixed-point Q15 -> float (reference: unit_vector.hpp:39-45)."""
    return x.astype(np.float32) / 32768.0


def f32_to_q15(x: np.ndarray) -> np.ndarray:
    """float -> Q15 with clamping (reference: unit_vector.hpp:26-37)."""
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


def library_path() -> Path:
    """Where the codec for this source and these flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(CODEC_SOURCE.read_bytes())
    return BUILD_DIR / f"libclann_codec_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile native/codec.cpp with g++ unless its library exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if not cxx:
        raise SerializeError("native codec build failed: g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(CODEC_SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise SerializeError(f"native codec build failed:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))

    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.clann_ref_parse.restype = ctypes.c_void_p
    lib.clann_ref_parse.argtypes = [u8p, ctypes.c_uint64, ctypes.c_int32]
    lib.clann_ref_parse_chunk.restype = ctypes.c_int32
    lib.clann_ref_parse_chunk.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint64]
    lib.clann_ref_is_chunked.restype = ctypes.c_uint32
    lib.clann_ref_is_chunked.argtypes = [ctypes.c_void_p]
    lib.clann_ref_expected_maps.restype = ctypes.c_uint64
    lib.clann_ref_expected_maps.argtypes = [ctypes.c_void_p]
    lib.clann_ref_free.argtypes = [ctypes.c_void_p]
    lib.clann_ref_error.restype = ctypes.c_char_p
    lib.clann_ref_error.argtypes = [ctypes.c_void_p]
    for name in (
        "clann_ref_dims",
        "clann_ref_storage_len",
        "clann_ref_num_points",
        "clann_ref_num_maps",
        "clann_ref_last_rebuild",
        "clann_ref_num_sketch_fns",
        "clann_ref_num_hash_fns",
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_uint32
        fn.argtypes = [ctypes.c_void_p]
    lib.clann_ref_data.restype = ctypes.POINTER(ctypes.c_int16)
    lib.clann_ref_data.argtypes = [ctypes.c_void_p]
    lib.clann_ref_num_sketches.restype = ctypes.c_uint64
    lib.clann_ref_num_sketches.argtypes = [ctypes.c_void_p]
    lib.clann_ref_sketches.restype = ctypes.POINTER(ctypes.c_uint64)
    lib.clann_ref_sketches.argtypes = [ctypes.c_void_p]
    lib.clann_ref_map_len.restype = ctypes.c_uint64
    lib.clann_ref_map_len.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.clann_ref_map_indices.restype = ctypes.POINTER(ctypes.c_uint32)
    lib.clann_ref_map_indices.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.clann_ref_map_hashes.restype = ctypes.POINTER(ctypes.c_uint32)
    lib.clann_ref_map_hashes.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.clann_ref_map_hash_length.restype = ctypes.c_uint32
    lib.clann_ref_map_hash_length.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.clann_ref_sketch_fn_plane.restype = ctypes.POINTER(ctypes.c_int16)
    lib.clann_ref_sketch_fn_plane.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.clann_ref_hash_fn_plane.restype = ctypes.POINTER(ctypes.c_int16)
    lib.clann_ref_hash_fn_plane.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.clann_ref_hash_fn_signs.restype = ctypes.POINTER(ctypes.c_int8)
    lib.clann_ref_hash_fn_signs.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.clann_ref_source_info.argtypes = [
        ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_uint32)] * 4
    lib.clann_ref_est_info.restype = ctypes.c_uint32
    lib.clann_ref_est_info.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.clann_ref_est_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.clann_ref_est_data.argtypes = [ctypes.c_void_p]
    lib.clann_ref_num_rotations.restype = ctypes.c_int32
    lib.clann_ref_num_rotations.argtypes = [ctypes.c_void_p]

    lib.clann_ref_write_simhash.restype = ctypes.c_void_p
    lib.clann_ref_write_simhash.argtypes = [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_int16),
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_int16),
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint32, ctypes.c_uint32,
    ]
    lib.clann_ref_write_fhtcp.restype = ctypes.c_void_p
    lib.clann_ref_write_fhtcp.argtypes = [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_int16),
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_int32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int8),
        ctypes.c_uint32, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint32, ctypes.c_uint32,
    ]
    lib.clann_ref_write_chunk.restype = ctypes.c_void_p
    lib.clann_ref_write_chunk.argtypes = [
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    # extended accessors (pool/tensor/CP/MinHash/set-format)
    lib.clann_ref_source_kind.restype = ctypes.c_int32
    lib.clann_ref_source_kind.argtypes = [ctypes.c_void_p]
    lib.clann_ref_args_info.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), _u32p, _f32p,
        _u32p, _u32p,
    ]
    lib.clann_ref_sketch_args_info.argtypes = [ctypes.c_void_p, _u32p]
    lib.clann_ref_pool_info.restype = ctypes.c_uint32
    lib.clann_ref_pool_info.argtypes = [ctypes.c_void_p] + [_u32p] * 5
    lib.clann_ref_pool_indices.restype = _u32p
    lib.clann_ref_pool_indices.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, _u64p,
    ]
    lib.clann_ref_tensor_info.argtypes = [ctypes.c_void_p] + [_u32p] * 3
    lib.clann_ref_family_info.argtypes = [ctypes.c_void_p] + [_u32p] * 4
    lib.clann_ref_sketch_family_info.argtypes = [ctypes.c_void_p] + [_u32p] * 2
    lib.clann_ref_hash_fn_cp.restype = _i16p
    lib.clann_ref_hash_fn_cp.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, _u32p, _u32p, _u64p,
    ]
    lib.clann_ref_mh_fn_tabs.restype = _u64p
    lib.clann_ref_mh_fn_tabs.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
    ]
    lib.clann_ref_mh_fn_perm.restype = _u32p
    lib.clann_ref_mh_fn_perm.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, _u32p, _u64p,
    ]
    lib.clann_ref_set_total_tokens.restype = ctypes.c_uint64
    lib.clann_ref_set_total_tokens.argtypes = [ctypes.c_void_p]
    lib.clann_ref_set_lens.restype = _u64p
    lib.clann_ref_set_lens.argtypes = [ctypes.c_void_p]
    lib.clann_ref_set_tokens.restype = _u32p
    lib.clann_ref_set_tokens.argtypes = [ctypes.c_void_p]
    lib.clann_ref_sketch_source_info.argtypes = [ctypes.c_void_p] + [_u32p] * 4
    lib.clann_ref_num_sketch_mh_fns.restype = ctypes.c_uint32
    lib.clann_ref_num_sketch_mh_fns.argtypes = [ctypes.c_void_p]
    lib.clann_ref_num_hash_mh_fns.restype = ctypes.c_uint32
    lib.clann_ref_num_hash_mh_fns.argtypes = [ctypes.c_void_p]
    lib.clann_ref_write_v2.restype = ctypes.c_void_p
    lib.clann_ref_write_v2.argtypes = [ctypes.POINTER(RefWriteSpec)]
    lib.clann_ref_out_data.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.clann_ref_out_data.argtypes = [ctypes.c_void_p]
    lib.clann_ref_out_len.restype = ctypes.c_uint64
    lib.clann_ref_out_len.argtypes = [ctypes.c_void_p]
    lib.clann_ref_out_free.argtypes = [ctypes.c_void_p]

    _lib = lib
    return lib


class ReferenceIndexData:
    """Arrays extracted from a reference PUFFINN index stream."""

    def __init__(self):
        self.dims = 0
        self.storage_len = 0
        self.vectors_q15: Optional[np.ndarray] = None  # (n, storage_len) i16
        self.sketches: Optional[np.ndarray] = None  # (n, 32) u64
        self.map_indices: list = []  # per table (len,) u32
        self.map_hashes: list = []  # per table (len,) u32
        self.hash_lengths: list = []
        self.sketch_planes: Optional[np.ndarray] = None  # (F, storage_len) i16
        self.hash_planes: Optional[np.ndarray] = None  # (F, storage_len) i16
        self.fht_signs: Optional[np.ndarray] = None  # (F, R, 2^log_dims) i8
        # FHT-CP Monte-Carlo collision table as stored in the stream
        # (CrossPolytopeCollisionEstimates, crosspolytope.hpp:10-119) —
        # kept so re-exports can pass the reference's own tabulation back
        # through byte-identically
        self.estimates: Optional[np.ndarray] = None  # (rows, cols) f32
        self.est_reps = 0
        self.est_eps = 0.0
        self.num_rotations = 3
        self.num_hashers = 0
        self.functions_per_hasher = 0
        self.bits_per_function = 1
        self.bits_to_cut = 0
        self.last_rebuild = 0
        # extended (round 2): source kind + family beyond the cosine
        # defaults. All stream fields are retained so reemit() is
        # byte-identical (deserialize.hpp:10-23 tag dispatch).
        self.family = FAMILY_SIMHASH
        self.source_kind = SOURCE_INDEPENDENT
        self.pool_size = 0  # HashPoolArgs pool_size (pool.hpp:199-220)
        self.pool_indices: Optional[list] = None  # per-table u32 arrays
        self.pool_bits_per_hasher = 0
        self.pool_sampling_rep = 0
        self.pool_bits_to_cut = 0
        self.pool_bits_per_function = 0
        self.tens_num_hashers = 0  # tensor.hpp:64-78
        self.tens_next_idx = 0
        self.tens_num_bits = 0
        self.cp_matrices: Optional[np.ndarray] = None  # (F, rows*padded) i16
        self.cp_dims = 0
        # MinHash machinery (jaccard): tabulation tables + permutations
        self.mh_tabs: Optional[np.ndarray] = None  # (F, 4*256) u64
        self.mh_perm_bits: Optional[np.ndarray] = None  # (F,) u32
        self.mh_perms: Optional[list] = None  # per-fn u32 arrays
        self.sk_mh_tabs: Optional[np.ndarray] = None
        self.sk_mh_perm_bits: Optional[np.ndarray] = None
        self.sk_mh_perms: Optional[list] = None
        self.mh_rand_bits = 0
        self.mh_set_size = 0
        self.sk_mh_rand_bits = 0
        self.sk_mh_set_size = 0
        self.sketch_hashers = 32
        self.sketch_fph = 0
        self.sketch_bits_per_function = 1
        self.sketch_cut = 0
        # SetFormat dataset (jaccard): dims == universe, storage_len == 1
        self.set_lens: Optional[np.ndarray] = None  # (n,) u64
        self.set_tokens: Optional[np.ndarray] = None  # concatenated u32

    @property
    def vectors(self) -> np.ndarray:
        return q15_to_f32(self.vectors_q15)

    def sets(self) -> list:
        """Per-point sorted token arrays (jaccard indexes)."""
        out = []
        off = 0
        for ln in self.set_lens:
            out.append(self.set_tokens[off : off + int(ln)])
            off += int(ln)
        return out


def parse_reference_stream(
    buf: bytes, family: int = FAMILY_SIMHASH, chunks: Optional[list] = None
) -> ReferenceIndexData:
    """Parse a reference index byte stream into arrays.

    `chunks`: per-table PrefixMap chunk streams for an index serialized with
    use_chunks=true (collection.hpp:178-209; upstream pickles store these as
    separate byte strings and replay them through deserialize_chunk).
    """
    lib = load_library()
    arr = np.frombuffer(bytearray(buf), dtype=np.uint8)
    h = lib.clann_ref_parse(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf), family
    )
    try:
        err = lib.clann_ref_error(h)
        if err:
            raise SerializeError(f"reference stream parse failed: {err.decode()}")
        if lib.clann_ref_is_chunked(h):
            expected = lib.clann_ref_expected_maps(h)
            got = len(chunks or [])
            if got != expected:
                raise SerializeError(
                    f"chunked stream expects {expected} map chunks, got {got}"
                )
            for c in chunks or []:
                carr = np.frombuffer(bytearray(c), dtype=np.uint8)
                ok = lib.clann_ref_parse_chunk(
                    h, carr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    len(c),
                )
                if not ok:
                    err = lib.clann_ref_error(h)
                    raise SerializeError(
                        "chunk parse failed: "
                        f"{err.decode() if err else 'unknown'}"
                    )
        elif chunks:
            raise SerializeError("chunks supplied for a non-chunked stream")
        out = ReferenceIndexData()
        out.family = family
        out.dims = lib.clann_ref_dims(h)
        out.storage_len = lib.clann_ref_storage_len(h)
        n = lib.clann_ref_num_points(h)
        if family == FAMILY_MINHASH:
            out.set_lens = np.ctypeslib.as_array(
                lib.clann_ref_set_lens(h), shape=(n,)
            ).copy() if n else np.zeros(0, np.uint64)
            tot = lib.clann_ref_set_total_tokens(h)
            out.set_tokens = np.ctypeslib.as_array(
                lib.clann_ref_set_tokens(h), shape=(tot,)
            ).copy() if tot else np.zeros(0, np.uint32)
        else:
            out.vectors_q15 = np.ctypeslib.as_array(
                lib.clann_ref_data(h), shape=(n, out.storage_len)
            ).copy()
        n_sk = lib.clann_ref_num_sketches(h)
        if n_sk:
            out.sketches = np.ctypeslib.as_array(
                lib.clann_ref_sketches(h), shape=(n_sk // 32, 32)
            ).copy()
        for m in range(lib.clann_ref_num_maps(h)):
            ln = lib.clann_ref_map_len(h, m)
            out.map_indices.append(
                np.ctypeslib.as_array(lib.clann_ref_map_indices(h, m), shape=(ln,)).copy()
            )
            out.map_hashes.append(
                np.ctypeslib.as_array(lib.clann_ref_map_hashes(h, m), shape=(ln,)).copy()
            )
            out.hash_lengths.append(lib.clann_ref_map_hash_length(h, m))

        def planes(count_fn, plane_fn):
            count = count_fn(h)
            rows = []
            for i in range(count):
                ln = ctypes.c_uint32()
                ptr = plane_fn(h, i, ctypes.byref(ln))
                rows.append(np.ctypeslib.as_array(ptr, shape=(ln.value,)).copy())
            return np.stack(rows) if rows else None

        def read_mh_fns(sketch: int, count: int):
            tabs, pbits, perms = [], [], []
            for fi in range(count):
                tabs.append(np.ctypeslib.as_array(
                    lib.clann_ref_mh_fn_tabs(h, sketch, fi), shape=(1024,)
                ).copy())
                pb = ctypes.c_uint32()
                ln = ctypes.c_uint64()
                ptr = lib.clann_ref_mh_fn_perm(
                    h, sketch, fi, ctypes.byref(pb), ctypes.byref(ln)
                )
                pbits.append(pb.value)
                perms.append(
                    np.ctypeslib.as_array(ptr, shape=(ln.value,)).copy()
                    if ln.value else np.zeros(0, np.uint32)
                )
            return (
                np.stack(tabs) if tabs else None,
                np.asarray(pbits, np.uint32),
                perms,
            )

        if family == FAMILY_MINHASH:
            out.sk_mh_tabs, out.sk_mh_perm_bits, out.sk_mh_perms = read_mh_fns(
                1, lib.clann_ref_num_sketch_mh_fns(h)
            )
            out.mh_tabs, out.mh_perm_bits, out.mh_perms = read_mh_fns(
                0, lib.clann_ref_num_hash_mh_fns(h)
            )
            rb = ctypes.c_uint32()
            lib.clann_ref_sketch_args_info(h, ctypes.byref(rb))
            out.sk_mh_rand_bits = rb.value
            srb = ctypes.c_uint32()
            sss = ctypes.c_uint32()
            lib.clann_ref_sketch_family_info(
                h, ctypes.byref(srb), ctypes.byref(sss)
            )
            out.sk_mh_rand_bits = srb.value
            out.sk_mh_set_size = sss.value
            frb = ctypes.c_uint32()
            fss = ctypes.c_uint32()
            fd = ctypes.c_uint32()
            fs = ctypes.c_uint32()
            lib.clann_ref_family_info(
                h, ctypes.byref(fd), ctypes.byref(fs), ctypes.byref(frb),
                ctypes.byref(fss),
            )
            out.mh_rand_bits = frb.value
            out.mh_set_size = fss.value
        else:
            out.sketch_planes = planes(
                lib.clann_ref_num_sketch_fns, lib.clann_ref_sketch_fn_plane
            )
        if family == FAMILY_SIMHASH:
            out.hash_planes = planes(
                lib.clann_ref_num_hash_fns, lib.clann_ref_hash_fn_plane
            )
        elif family == FAMILY_FHT_CROSS_POLYTOPE:
            rows = []
            for fi in range(lib.clann_ref_num_hash_fns(h)):
                log_dims = ctypes.c_int32()
                rotations = ctypes.c_uint32()
                ptr = lib.clann_ref_hash_fn_signs(
                    h, fi, ctypes.byref(log_dims), ctypes.byref(rotations)
                )
                rows.append(
                    np.ctypeslib.as_array(
                        ptr,
                        shape=(rotations.value, 1 << log_dims.value),
                    ).copy()
                )
            out.fht_signs = np.stack(rows) if rows else None
            out.num_rotations = lib.clann_ref_num_rotations(h)
        elif family == FAMILY_CROSS_POLYTOPE:
            rows = []
            for fi in range(lib.clann_ref_num_hash_fns(h)):
                dims = ctypes.c_uint32()
                padded = ctypes.c_uint32()
                ln = ctypes.c_uint64()
                ptr = lib.clann_ref_hash_fn_cp(
                    h, fi, ctypes.byref(dims), ctypes.byref(padded),
                    ctypes.byref(ln),
                )
                out.cp_dims = dims.value
                rows.append(
                    np.ctypeslib.as_array(ptr, shape=(ln.value,)).copy()
                )
            out.cp_matrices = np.stack(rows) if rows else None
        if family in (FAMILY_FHT_CROSS_POLYTOPE, FAMILY_CROSS_POLYTOPE):
            reps = ctypes.c_uint32()
            eps = ctypes.c_float()
            er = ctypes.c_uint32()
            ec = ctypes.c_uint32()
            if lib.clann_ref_est_info(
                h, ctypes.byref(reps), ctypes.byref(eps), ctypes.byref(er),
                ctypes.byref(ec),
            ):
                out.est_reps = reps.value
                out.est_eps = eps.value
                out.estimates = np.ctypeslib.as_array(
                    lib.clann_ref_est_data(h), shape=(er.value, ec.value)
                ).copy()
        # source kind + per-kind tails
        out.source_kind = lib.clann_ref_source_kind(h)
        nrot = ctypes.c_int32()
        areps = ctypes.c_uint32()
        aeps = ctypes.c_float()
        arb = ctypes.c_uint32()
        apool = ctypes.c_uint32()
        lib.clann_ref_args_info(
            h, ctypes.byref(nrot), ctypes.byref(areps), ctypes.byref(aeps),
            ctypes.byref(arb), ctypes.byref(apool),
        )
        out.pool_size = apool.value
        if family == FAMILY_MINHASH:
            out.mh_rand_bits = arb.value or out.mh_rand_bits
        if out.source_kind == SOURCE_POOL:
            nt = ctypes.c_uint32()
            pbf = ctypes.c_uint32()
            pbh = ctypes.c_uint32()
            psr = ctypes.c_uint32()
            pct = ctypes.c_uint32()
            count = lib.clann_ref_pool_info(
                h, ctypes.byref(nt), ctypes.byref(pbf), ctypes.byref(pbh),
                ctypes.byref(psr), ctypes.byref(pct),
            )
            out.pool_bits_per_function = pbf.value
            out.pool_bits_per_hasher = pbh.value
            out.pool_sampling_rep = psr.value
            out.pool_bits_to_cut = pct.value
            out.pool_indices = []
            for t in range(count):
                ln = ctypes.c_uint64()
                ptr = lib.clann_ref_pool_indices(h, t, ctypes.byref(ln))
                out.pool_indices.append(
                    np.ctypeslib.as_array(ptr, shape=(ln.value,)).copy()
                )
        elif out.source_kind == SOURCE_TENSOR:
            tnh = ctypes.c_uint32()
            tni = ctypes.c_uint32()
            tnb = ctypes.c_uint32()
            lib.clann_ref_tensor_info(
                h, ctypes.byref(tnh), ctypes.byref(tni), ctypes.byref(tnb)
            )
            out.tens_num_hashers = tnh.value
            out.tens_next_idx = tni.value
            out.tens_num_bits = tnb.value
        nh = ctypes.c_uint32()
        fph = ctypes.c_uint32()
        bpf = ctypes.c_uint32()
        cut = ctypes.c_uint32()
        lib.clann_ref_source_info(
            h, ctypes.byref(nh), ctypes.byref(fph), ctypes.byref(bpf),
            ctypes.byref(cut),
        )
        out.num_hashers = nh.value
        out.functions_per_hasher = fph.value
        out.bits_per_function = bpf.value
        out.bits_to_cut = cut.value
        lib.clann_ref_sketch_source_info(
            h, ctypes.byref(nh), ctypes.byref(fph), ctypes.byref(bpf),
            ctypes.byref(cut),
        )
        out.sketch_hashers = nh.value
        out.sketch_fph = fph.value
        out.sketch_bits_per_function = bpf.value
        out.sketch_cut = cut.value
        out.last_rebuild = lib.clann_ref_last_rebuild(h)
        return out
    finally:
        lib.clann_ref_free(h)


def write_reference_stream(
    vectors_q15: np.ndarray,
    dims: int,
    sketch_planes: np.ndarray,
    sketches: np.ndarray,
    hash_planes: np.ndarray,
    num_hashers: int,
    functions_per_hasher: int,
    bits_to_cut: int,
    map_indices: list,
    map_hashes: list,
    last_rebuild: int,
    use_chunks: bool = False,
):
    """Emit a reference-loadable SimHash/independent index stream.

    With use_chunks=True, returns (main_stream, [chunk_bytes]) following the
    reference's chunked layout (collection.hpp:184-209): the main stream
    records num_maps + use_chunks=1 but omits the PrefixMaps, which are
    emitted one per chunk.
    """
    lib = load_library()
    vec = np.ascontiguousarray(vectors_q15, dtype=np.int16)
    n, storage_len = vec.shape
    skp = np.ascontiguousarray(sketch_planes, dtype=np.int16)
    sk = np.ascontiguousarray(sketches, dtype=np.uint64).reshape(-1)
    hp = np.ascontiguousarray(hash_planes, dtype=np.int16)
    lens = np.asarray([len(m) for m in map_indices], dtype=np.uint64)
    mi = np.ascontiguousarray(
        np.concatenate(map_indices) if map_indices else np.zeros(0), dtype=np.uint32
    )
    mh = np.ascontiguousarray(
        np.concatenate(map_hashes) if map_hashes else np.zeros(0), dtype=np.uint32
    )
    i16p = ctypes.POINTER(ctypes.c_int16)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    h = lib.clann_ref_write_simhash(
        dims, storage_len, n, vec.ctypes.data_as(i16p),
        skp.shape[0], skp.ctypes.data_as(i16p),
        sk.size, sk.ctypes.data_as(u64p),
        32, sketch_planes.shape[0] // 32, 0,
        hp.shape[0], hp.ctypes.data_as(i16p),
        num_hashers, functions_per_hasher, bits_to_cut,
        len(map_indices), lens.ctypes.data_as(u64p),
        mi.ctypes.data_as(u32p), mh.ctypes.data_as(u32p),
        last_rebuild, 1 if use_chunks else 0,
    )
    try:
        ln = lib.clann_ref_out_len(h)
        data = np.ctypeslib.as_array(lib.clann_ref_out_data(h), shape=(ln,))
        main = bytes(data)
    finally:
        lib.clann_ref_out_free(h)
    if not use_chunks:
        return main
    return main, _write_chunks(lib, map_indices, map_hashes)


def _fetch_out(lib, h) -> bytes:
    try:
        ln = lib.clann_ref_out_len(h)
        return bytes(
            np.ctypeslib.as_array(lib.clann_ref_out_data(h), shape=(ln,))
        )
    finally:
        lib.clann_ref_out_free(h)


def _ptr(arr, ctype):
    if arr is None:
        return None
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def write_reference_stream_v2(d: "ReferenceIndexData", use_chunks=False):
    """Emit a reference-loadable stream for ANY (family x source) combo.

    Takes a fully populated ReferenceIndexData — either parsed from a
    reference stream (byte-identical re-emission, the codec's round-trip
    contract) or assembled by io/interop.py from an index. With
    use_chunks, returns (main, [chunk_bytes]).
    """
    lib = load_library()
    s = RefWriteSpec()
    s.family = d.family
    s.source_kind = d.source_kind
    s.dims = d.dims
    s.storage_len = d.storage_len
    keep = []  # keep contiguous temporaries alive until the C call returns

    def c(arr, dtype):
        if arr is None:
            return None
        a = np.ascontiguousarray(arr, dtype=dtype)
        keep.append(a)
        return a

    if d.family == FAMILY_MINHASH:
        lens = c(d.set_lens, np.uint64)
        toks = c(d.set_tokens, np.uint32)
        s.n = len(lens)
        s.set_lens = _ptr(lens, ctypes.c_uint64)
        s.set_tokens = _ptr(toks, ctypes.c_uint32)
    else:
        vec = c(d.vectors_q15, np.int16)
        s.n = vec.shape[0]
        s.unit_data = _ptr(vec, ctypes.c_int16)
    s.num_rotations = d.num_rotations
    s.est_reps = d.est_reps
    s.est_eps = d.est_eps
    s.mh_rand_bits = d.mh_rand_bits
    s.mh_set_size = d.mh_set_size
    s.pool_size = d.pool_size
    if d.estimates is not None:
        est = c(d.estimates, np.float32)
        s.estimates = _ptr(est, ctypes.c_float)
        s.est_rows, s.est_cols = est.shape
    # table hash functions
    if d.family == FAMILY_SIMHASH:
        hp = c(d.hash_planes, np.int16)
        s.num_hash_fns = 0 if hp is None else hp.shape[0]
        s.planes = _ptr(hp, ctypes.c_int16)
    elif d.family == FAMILY_FHT_CROSS_POLYTOPE:
        sg = c(d.fht_signs, np.int8)
        if sg is not None:
            s.num_hash_fns, s.rotations = sg.shape[0], sg.shape[1]
            s.log_dims = int(np.log2(sg.shape[2]))
            s.signs = _ptr(sg, ctypes.c_int8)
    elif d.family == FAMILY_CROSS_POLYTOPE:
        cm = c(d.cp_matrices, np.int16)
        if cm is not None:
            s.num_hash_fns = cm.shape[0]
            s.cp_matrices = _ptr(cm, ctypes.c_int16)
        # CP functions serialize their own dims (crosspolytope.hpp:348-354)
        # which equal the dataset dims here
    elif d.family == FAMILY_MINHASH:
        tabs = c(d.mh_tabs, np.uint64)
        if tabs is not None:
            s.num_hash_fns = tabs.shape[0]
            s.mh_tabs = _ptr(tabs, ctypes.c_uint64)
            pb = c(d.mh_perm_bits, np.uint32)
            pl = c(np.asarray([len(p) for p in d.mh_perms]), np.uint64)
            pc = c(
                np.concatenate(d.mh_perms)
                if any(len(p) for p in d.mh_perms)
                else np.zeros(0),
                np.uint32,
            )
            s.mh_perm_bits = _ptr(pb, ctypes.c_uint32)
            s.mh_perm_lens = _ptr(pl, ctypes.c_uint64)
            s.mh_perms = _ptr(pc, ctypes.c_uint32)
    s.num_hashers = d.num_hashers
    s.functions_per_hasher = d.functions_per_hasher
    s.bits_per_function = d.bits_per_function
    s.next_function = 0  # always 0 in reference streams (independent.hpp:15)
    s.bits_to_cut = d.bits_to_cut
    if d.source_kind == SOURCE_POOL:
        s.pool_num_tables = len(d.pool_indices)
        pil = c(np.asarray([len(p) for p in d.pool_indices]), np.uint64)
        pic = c(np.concatenate(d.pool_indices), np.uint32)
        s.pool_index_lens = _ptr(pil, ctypes.c_uint64)
        s.pool_indices = _ptr(pic, ctypes.c_uint32)
        s.pool_bits_per_hasher = d.pool_bits_per_hasher
        s.pool_sampling_rep = d.pool_sampling_rep
        s.pool_bits_to_cut = d.pool_bits_to_cut
        s.bits_per_function = d.pool_bits_per_function
    elif d.source_kind == SOURCE_TENSOR:
        s.tens_num_hashers = d.tens_num_hashers
        s.tens_next_idx = d.tens_next_idx
        s.tens_num_bits = d.tens_num_bits
    # sketches
    s.sk_mh_rand_bits = d.sk_mh_rand_bits
    s.sk_mh_set_size = d.sk_mh_set_size
    if d.family == FAMILY_MINHASH:
        sk_tabs = c(d.sk_mh_tabs, np.uint64)
        if sk_tabs is not None:
            s.num_sketch_fns = sk_tabs.shape[0]
            s.sk_mh_tabs = _ptr(sk_tabs, ctypes.c_uint64)
            spb = c(d.sk_mh_perm_bits, np.uint32)
            spl = c(np.asarray([len(p) for p in d.sk_mh_perms]), np.uint64)
            spc = c(
                np.concatenate(d.sk_mh_perms)
                if any(len(p) for p in d.sk_mh_perms)
                else np.zeros(0),
                np.uint32,
            )
            s.sk_mh_perm_bits = _ptr(spb, ctypes.c_uint32)
            s.sk_mh_perm_lens = _ptr(spl, ctypes.c_uint64)
            s.sk_mh_perms = _ptr(spc, ctypes.c_uint32)
    else:
        skp = c(d.sketch_planes, np.int16)
        s.num_sketch_fns = 0 if skp is None else skp.shape[0]
        s.sketch_planes = _ptr(skp, ctypes.c_int16)
    s.sketch_hashers = d.sketch_hashers
    s.sketch_fph = d.sketch_fph
    s.sketch_bits_per_function = d.sketch_bits_per_function
    s.sketch_cut = d.sketch_cut
    sk = c(np.asarray(d.sketches).reshape(-1) if d.sketches is not None
           else np.zeros(0), np.uint64)
    s.sketches = _ptr(sk, ctypes.c_uint64)
    s.num_sketch_words = sk.size
    # maps
    s.num_maps = len(d.map_indices)
    s.use_chunks = 1 if use_chunks else 0
    ml = c(np.asarray([len(m) for m in d.map_indices]), np.uint64)
    mi = c(
        np.concatenate(d.map_indices) if d.map_indices else np.zeros(0),
        np.uint32,
    )
    mh = c(
        np.concatenate(d.map_hashes) if d.map_hashes else np.zeros(0),
        np.uint32,
    )
    s.map_lens = _ptr(ml, ctypes.c_uint64)
    s.map_indices = _ptr(mi, ctypes.c_uint32)
    s.map_hashes = _ptr(mh, ctypes.c_uint32)
    s.last_rebuild = d.last_rebuild
    main = _fetch_out(lib, lib.clann_ref_write_v2(ctypes.byref(s)))
    del keep
    if not use_chunks:
        return main
    return main, _write_chunks(lib, d.map_indices, d.map_hashes)


def _write_chunks(lib, map_indices: list, map_hashes: list) -> list:
    """One serialized PrefixMap chunk per table (collection.hpp:171-176)."""
    u32p = ctypes.POINTER(ctypes.c_uint32)
    chunks = []
    for mi, mh in zip(map_indices, map_hashes):
        mi = np.ascontiguousarray(mi, dtype=np.uint32)
        mh = np.ascontiguousarray(mh, dtype=np.uint32)
        h = lib.clann_ref_write_chunk(
            len(mi), mi.ctypes.data_as(u32p), mh.ctypes.data_as(u32p)
        )
        try:
            ln = lib.clann_ref_out_len(h)
            chunks.append(bytes(
                np.ctypeslib.as_array(lib.clann_ref_out_data(h), shape=(ln,))
            ))
        finally:
            lib.clann_ref_out_free(h)
    return chunks


def write_reference_stream_fhtcp(
    vectors_q15: np.ndarray,
    dims: int,
    sketch_planes: np.ndarray,
    sketches: np.ndarray,
    signs: np.ndarray,  # (F, R, 2^log_dims) +-1 int8
    estimates: np.ndarray,  # (log_dims+2, n_buckets) f32
    est_reps: int,
    est_eps: float,
    num_hashers: int,
    functions_per_hasher: int,
    bits_to_cut: int,
    map_indices: list,
    map_hashes: list,
    last_rebuild: int,
    use_chunks: bool = False,
):
    """Emit a reference-loadable FHT-cross-polytope/independent stream
    (the reference cosine default, similarity_measure/cosine.hpp:16).
    With use_chunks=True returns (main_stream, [chunk_bytes])."""
    lib = load_library()
    vec = np.ascontiguousarray(vectors_q15, dtype=np.int16)
    n, storage_len = vec.shape
    skp = np.ascontiguousarray(sketch_planes, dtype=np.int16)
    sk = np.ascontiguousarray(sketches, dtype=np.uint64).reshape(-1)
    sg = np.ascontiguousarray(signs, dtype=np.int8)
    F, R, dp = sg.shape
    log_dims = int(np.log2(dp))
    est = np.ascontiguousarray(estimates, dtype=np.float32)
    lens = np.asarray([len(m) for m in map_indices], dtype=np.uint64)
    mi = np.ascontiguousarray(
        np.concatenate(map_indices) if map_indices else np.zeros(0), dtype=np.uint32
    )
    mh = np.ascontiguousarray(
        np.concatenate(map_hashes) if map_hashes else np.zeros(0), dtype=np.uint32
    )
    i8p = ctypes.POINTER(ctypes.c_int8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    f32p = ctypes.POINTER(ctypes.c_float)
    h = lib.clann_ref_write_fhtcp(
        dims, storage_len, n, vec.ctypes.data_as(i16p),
        skp.shape[0], skp.ctypes.data_as(i16p),
        sk.size, sk.ctypes.data_as(u64p),
        32, sketch_planes.shape[0] // 32, 0,
        F, log_dims, R, sg.ctypes.data_as(i8p),
        est_reps, est_eps,
        est.ctypes.data_as(f32p), est.shape[0], est.shape[1],
        num_hashers, functions_per_hasher, bits_to_cut,
        len(map_indices), lens.ctypes.data_as(u64p),
        mi.ctypes.data_as(u32p), mh.ctypes.data_as(u32p),
        last_rebuild, 1 if use_chunks else 0,
    )
    try:
        ln = lib.clann_ref_out_len(h)
        data = np.ctypeslib.as_array(lib.clann_ref_out_data(h), shape=(ln,))
        main = bytes(data)
    finally:
        lib.clann_ref_out_free(h)
    if not use_chunks:
        return main
    return main, _write_chunks(lib, map_indices, map_hashes)
