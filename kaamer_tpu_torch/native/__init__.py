"""ctypes bindings for the native build-pipeline kernels (the port's copy
of kaamer_tpu/native: kaamer_native.cpp is the same source).

The shared library is compiled with g++ at first use (no Python headers
required) into kaamer_tpu_torch/build/, not beside the source.  Every
entry point has a pure numpy fallback, so the package works without a
toolchain; `available()` reports which path is active.  The port binds
the entry points its paths use: pair extraction and the sort of the
database build, the query wire packer, the six-frame ORF scan of
translated search, and the FASTA scanner (parse_fasta_bytes).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "kaamer_native.cpp")
_LIB = os.path.join(os.path.dirname(_DIR), "build", "libkaamer_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            if (not os.path.exists(_LIB)
                    or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
                os.makedirs(os.path.dirname(_LIB), exist_ok=True)
                tmp = f"{_LIB}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-pthread", "-std=c++17", _SRC, "-o", tmp],
                    check=True, capture_output=True,
                )
                os.replace(tmp, _LIB)
            lib = ctypes.CDLL(_LIB)
            lib.kt_extract_pairs.restype = ctypes.c_int64
            lib.kt_extract_pairs.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
            ]
            lib.kt_parse_fasta.restype = ctypes.c_int64
            lib.kt_parse_fasta.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64,
            ]
            lib.kt_pack_queries.restype = ctypes.c_int64
            lib.kt_pack_queries.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
            ]
            lib.kt_get_orfs.restype = ctypes.c_int64
            lib.kt_get_orfs.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # dna
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # tables
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,  # seq out
                ctypes.c_void_p,                                   # meta
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,  # alts out
                ctypes.c_int64,                                    # max_orfs
                ctypes.c_int,                                      # n_threads
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def _threads() -> int:
    return min(16, os.cpu_count() or 1)


def extract_pairs(seq_buf: np.ndarray, offsets: np.ndarray,
                  row_base: int) -> np.ndarray:
    """(kmer<<32 | row) pairs for concatenated sequences.

    seq_buf: uint8[total]; offsets: int64[n+1]."""
    lib = _load()
    n = offsets.shape[0] - 1
    lens = np.diff(offsets)
    total = int(np.maximum(lens - 6, 0).sum())
    if lib is None:
        from .. import codec

        chunks = []
        for i in range(n):
            s = seq_buf[offsets[i]:offsets[i + 1]]
            codes = codec.CHAR_TO_CODE[s]
            kmers = codec.encode_kmers_np(codes)
            chunks.append(
                (kmers.astype(np.uint64) << np.uint64(32))
                | np.uint64(row_base + i)
            )
        return np.concatenate(chunks) if chunks else np.empty(0, np.uint64)

    out = np.empty(total, dtype=np.uint64)
    seq_buf = np.ascontiguousarray(seq_buf)
    offsets = np.ascontiguousarray(offsets.astype(np.int64))
    written = lib.kt_extract_pairs(
        seq_buf.ctypes.data, offsets.ctypes.data, n, row_base,
        out.ctypes.data, _threads(),
    )
    assert written == total
    return out


def pack_queries(seqs, width: int):
    """Fused query wire packing: sequences -> uint32[B, ceil(width/7)] in
    the base-22 7-residues/word format (equivalent of codec.pad_codes_batch
    + codec.pack_codes7, the dominant serial host cost per dispatched
    batch).  Returns None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    B = len(seqs)
    n_words = -(-width // 7)
    buf = "".join(seqs).encode("latin-1")
    seq_buf = np.frombuffer(buf, dtype=np.uint8)
    offsets = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(np.fromiter((len(s) for s in seqs), count=B, dtype=np.int64),
              out=offsets[1:])
    out = np.empty((B, n_words), dtype=np.uint32)
    written = lib.kt_pack_queries(
        seq_buf.ctypes.data if seq_buf.size else 0, offsets.ctypes.data,
        B, width, out.ctypes.data, _threads(),
    )
    assert written == B * n_words
    return out


def sort_u64(arr: np.ndarray) -> np.ndarray:
    """Sort a uint64 array in place.  numpy's introsort measures faster than
    the C++ LSD radix here (cache-hostile 256-way scatter), so it is the
    default; kt_sort_u64 remains exported for reuse."""
    arr.sort()
    return arr


def get_orfs_raw(dna_buf: np.ndarray, dna_off: np.ndarray,
                 aa: np.ndarray, start: np.ndarray, stop: np.ndarray,
                 n_threads: int = 0):
    """Six-frame ORF scan over concatenated DNA sequences (kt_get_orfs),
    multithreaded over contiguous sequence slices (bit-identical to the
    Python scan of search/orf.py; tests/test_torch_translated.py holds
    both against the JAX package's).

    dna_buf: uint8[total]; dna_off: int64[n+1]; aa/start/stop: the 65-entry
    tables from gcode.translation_arrays.  Returns (seq_buf, seq_off, meta,
    alts_buf, alts_off) flat arrays trimmed to the ORF count, or None when
    the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    total = int(dna_off[-1])
    n_seqs = dna_off.shape[0] - 1
    # 6 frames hold <= 2*total aa + per-frame '*' slack
    seq_cap = 2 * total + 12 * n_seqs + 64
    alts_cap = total + 6 * n_seqs + 64
    max_orfs = 2 * total // (3 * 21) + 6 * n_seqs + 64
    dna_buf = np.ascontiguousarray(dna_buf)
    dna_off = np.ascontiguousarray(dna_off.astype(np.int64))
    aa_c = np.ascontiguousarray(aa.astype(np.uint8))
    start_c = np.ascontiguousarray(start.astype(np.uint8))
    stop_c = np.ascontiguousarray(stop.astype(np.uint8))
    seq_buf = np.empty(seq_cap, dtype=np.uint8)
    seq_off = np.zeros(max_orfs + 1, dtype=np.int64)
    meta = np.empty((max_orfs, 4), dtype=np.int32)
    alts_buf = np.empty(alts_cap, dtype=np.int32)
    alts_off = np.zeros(max_orfs + 1, dtype=np.int64)
    n = lib.kt_get_orfs(
        dna_buf.ctypes.data, dna_off.ctypes.data, n_seqs,
        aa_c.ctypes.data, start_c.ctypes.data, stop_c.ctypes.data,
        seq_buf.ctypes.data, seq_cap, seq_off.ctypes.data,
        meta.ctypes.data,
        alts_buf.ctypes.data, alts_cap, alts_off.ctypes.data,
        max_orfs, n_threads or _threads(),
    )
    assert n >= 0, "kt_get_orfs capacity overflow (bounds are analytic)"
    return (seq_buf, seq_off[: n + 1], meta[:n], alts_buf, alts_off[: n + 1])


def parse_fasta_bytes(data: bytes):
    """Scan FASTA bytes -> (seq_buf, seq_off, headers list).  Returns None
    when the native library is unavailable (callers fall back to the Python
    parser)."""
    lib = _load()
    if lib is None:
        return None
    n_max = data.count(b">") + 1
    inp = np.frombuffer(data, dtype=np.uint8)
    seq_buf = np.empty(len(data), dtype=np.uint8)
    hdr_buf = np.empty(len(data), dtype=np.uint8)
    seq_off = np.zeros(n_max + 1, dtype=np.int64)
    hdr_off = np.zeros(n_max + 1, dtype=np.int64)
    n = lib.kt_parse_fasta(
        inp.ctypes.data, len(data), seq_buf.ctypes.data, seq_off.ctypes.data,
        hdr_buf.ctypes.data, hdr_off.ctypes.data, n_max,
    )
    headers = [
        bytes(hdr_buf[hdr_off[i]:hdr_off[i + 1]]).decode("utf-8", "replace")
        for i in range(n)
    ]
    return seq_buf, seq_off[: n + 1], headers
