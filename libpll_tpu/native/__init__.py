"""Native (C++) host-runtime kernels, loaded via ctypes.

The reference's host layer is C (fasta.c, compress.c, tip encoding in
pll.c); this package provides the rebuild's native equivalents — see
host.cpp.  The shared library is built on demand with g++ (no Python
headers, pure C ABI) and cached next to the source; every entry point has a
pure-Python fallback in the calling module, so the package works without a
compiler too (``available()`` reports which path is active).
"""

from __future__ import annotations

import ctypes as ct
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "host.cpp")
_LIB = os.path.join(_DIR, "libpllhost.so")
_lock = threading.Lock()
_lib: Optional[ct.CDLL] = None
_failed = False


def _build() -> None:
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           _SRC, "-o", _LIB]
    subprocess.run(cmd, check=True, capture_output=True)


def _declare(lib: ct.CDLL) -> None:
    i64 = ct.c_longlong
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")

    lib.pllhost_compress_patterns.restype = i64
    lib.pllhost_compress_patterns.argtypes = [u8p, i64, i64, u32p, u8p, u64p]
    lib.pllhost_encode_tips.restype = i64
    lib.pllhost_encode_tips.argtypes = [u8p, i64, u32p, u32p]
    lib.pllhost_fasta_scan.restype = i64
    # outputs passed as raw pointers (None for the counting pass)
    lib.pllhost_fasta_scan.argtypes = [u8p, i64, ct.c_void_p, ct.c_void_p,
                                       ct.c_void_p, ct.c_void_p]
    lib.pllhost_fasta_pack.restype = i64
    lib.pllhost_fasta_pack.argtypes = [u8p, i64, i64, u32p, u8p,
                                       ct.c_void_p]


def get_lib() -> Optional[ct.CDLL]:
    """The loaded native library, building it on first use; None when no
    toolchain is available (callers use their Python fallbacks)."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            if (not os.path.exists(_LIB)
                    or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
                _build()
            lib = ct.CDLL(_LIB)
            _declare(lib)
            _lib = lib
        except Exception:
            _failed = True
    return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# High-level wrappers (None return = caller should use its Python fallback)
# ---------------------------------------------------------------------------

def compress_patterns(matrix: np.ndarray, charmap: np.ndarray
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """[n_seq, n_sites] uint8 alignment -> (patterns [n_seq, n_patterns],
    weights uint64); raises ValueError on illegal characters."""
    lib = get_lib()
    if lib is None:
        return None
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    n_seq, n_sites = matrix.shape
    cm = np.ascontiguousarray(charmap, dtype=np.uint32)
    out = np.empty_like(matrix)
    weights = np.zeros(n_sites, dtype=np.uint64)
    rc = lib.pllhost_compress_patterns(matrix, n_seq, n_sites, cm, out,
                                       weights)
    if rc < 0:
        raise ValueError(f"illegal character at alignment offset {-rc - 1}")
    np_ = int(rc)
    return out.reshape(-1)[:n_seq * np_].reshape(n_seq, np_), weights[:np_]


def encode_tips(seq: bytes, charmap: np.ndarray) -> Optional[np.ndarray]:
    """Sequence bytes -> uint32 state bitmasks; raises ValueError with the
    offending position on illegal characters."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.frombuffer(seq, dtype=np.uint8)
    cm = np.ascontiguousarray(charmap, dtype=np.uint32)
    out = np.empty(arr.size, dtype=np.uint32)
    rc = lib.pllhost_encode_tips(np.ascontiguousarray(arr), arr.size, cm, out)
    if rc:
        raise ValueError(f"illegal character at position {rc - 1}")
    return out


def fasta_scan(data: bytes, charmap: np.ndarray
               ) -> Optional[Tuple[list, list, list]]:
    """In-memory FASTA image -> (headers, packed sequences, strip counts);
    raises ValueError on structural or character errors.  The charmap uses
    the reference fasta.c validity codes: 1 keep, 2 fatal, other strip."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))
    n = arr.size
    count = lib.pllhost_fasta_scan(arr, n, None, None, None, None)
    if count < 0:
        raise ValueError(f"invalid FASTA structure at line {-count - 1}")
    if count == 0:
        return [], []
    hs = np.empty(count, np.int64)
    he = np.empty(count, np.int64)
    ss = np.empty(count, np.int64)
    se = np.empty(count, np.int64)
    lib.pllhost_fasta_scan(arr, n, hs.ctypes.data, he.ctypes.data,
                           ss.ctypes.data, se.ctypes.data)
    cm = np.ascontiguousarray(charmap, dtype=np.uint32)
    headers, seqs, strips = [], [], []
    nstr = ct.c_longlong(0)
    for i in range(count):
        headers.append(bytes(arr[hs[i]:he[i]]).decode("latin-1").strip())
        buf = np.empty(int(se[i] - ss[i]), dtype=np.uint8)
        k = lib.pllhost_fasta_pack(arr, int(ss[i]), int(se[i]), cm, buf,
                                   ct.addressof(nstr))
        if k < 0:
            raise ValueError(
                f"illegal character in record {i} at offset {-k - 1}")
        seqs.append(bytes(buf[:k]).decode("latin-1"))
        strips.append(int(nstr.value))
    return headers, seqs, strips
