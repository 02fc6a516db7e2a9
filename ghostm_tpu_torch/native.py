"""ctypes bindings for the port's host library (csrc/host/ghostm_native.cpp).

Host code, not a kernel: the seed-index counting sort, the FASTA reader and
the BLAST-m8 row formatter, in C++ with a plain C interface. The library is
built by the host C++ compiler (`$CXX`, default g++) at first use into
`<checkout>/build/native/`, named by a hash of the source, the compiler and
the flags, so it is never stale. It is written to a temporary name and
moved into place, so a process never loads a half-written library while
another builds it.

When no compiler is found (or the build fails), every function here returns
None and its caller takes the Python / numpy path, which gives the same
bytes (tests/test_torch_native.py); this is logged once at warning level.
CALLS counts each call by route, ("kmer_csr" | "read_fasta_protein" |
"m8_format", "native" | "python"), so a run can show which one it took.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger("ghostm_tpu_torch.native")

SOURCE = Path(__file__).resolve().parent / "csrc" / "host" / "ghostm_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "native"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

CALLS: Counter = Counter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def reset_calls() -> None:
    CALLS.clear()


def lib_path(cxx: str) -> Path:
    """The library's path for compiler `cxx`: a hash of the source, the
    compiler and the flags."""
    h = hashlib.sha256()
    h.update(" ".join((cxx,) + CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libghostm_native-{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    cxx = os.environ.get("CXX", "g++")
    out = lib_path(cxx)
    if out.exists():
        return out
    if shutil.which(cxx) is None:
        log.warning("no C++ compiler (%s): the native host code is not "
                    "built; taking the Python / numpy paths", cxx)
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, text=True,
                       timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", "") or e
        log.warning("native host code failed to build, taking the Python / "
                    "numpy paths: %s", detail)
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            log.warning("native host library failed to load, taking the "
                        "Python / numpy paths: %s", e)
            return None
        p = ctypes.c_void_p
        lib.kmer_csr.restype = ctypes.c_int64
        lib.kmer_csr.argtypes = [p, ctypes.c_int64, ctypes.c_int32, p, p, p]
        lib.fasta_scan.restype = ctypes.c_int
        lib.fasta_scan.argtypes = [ctypes.c_char_p] + [p] * 3
        lib.fasta_read.restype = ctypes.c_int
        lib.fasta_read.argtypes = [ctypes.c_char_p] + [p] * 5
        lib.m8_format_rows.restype = ctypes.c_int64
        lib.m8_format_rows.argtypes = [ctypes.c_int64] + [p] * 17 + [
            ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _route(name: str) -> Optional[ctypes.CDLL]:
    """The library, counting this call of `name` by the route it takes."""
    lib = _load()
    CALLS[(name, "python" if lib is None else "native")] += 1
    return lib


def kmer_csr(
    buf: np.ndarray, k: int, keep: Optional[np.ndarray] = None
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Counting-sort seed-index build: (positions int32, bucket_starts
    int32 (20^k + 2,)), as index.seeds.build_seed_index's numpy path
    returns them, or None without the library."""
    lib = _route("kmer_csr")
    if lib is None:
        return None
    buf = np.ascontiguousarray(buf, dtype=np.int8)
    positions = np.empty(max(len(buf), 1), dtype=np.int32)
    bucket_starts = np.zeros(20**k + 2, dtype=np.int32)
    keep_ptr = None
    if keep is not None:
        keep_arr = np.ascontiguousarray(keep, dtype=np.uint8)
        keep_ptr = keep_arr.ctypes.data_as(ctypes.c_void_p)
    n = lib.kmer_csr(
        buf.ctypes.data_as(ctypes.c_void_p), len(buf), k, keep_ptr,
        positions.ctypes.data_as(ctypes.c_void_p),
        bucket_starts.ctypes.data_as(ctypes.c_void_p),
    )
    return positions[:n].copy(), bucket_starts


def read_fasta_protein(
    path: str,
) -> Optional[Tuple[List[str], List[np.ndarray]]]:
    """A protein FASTA file -> (names, encoded int8 sequences), each name
    the header's first token; None without the library or when the file
    cannot be opened."""
    lib = _route("read_fasta_protein")
    if lib is None:
        return None
    nrec, nres, nname = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    if lib.fasta_scan(path.encode(), ctypes.byref(nrec), ctypes.byref(nres),
                      ctypes.byref(nname)):
        return None
    if nrec.value == 0:
        return [], []
    arena = np.empty(max(nres.value, 1), dtype=np.int8)
    starts = np.empty(nrec.value, dtype=np.int64)
    lens = np.empty(nrec.value, dtype=np.int64)
    names_buf = ctypes.create_string_buffer(max(nname.value, 1))
    name_offs = np.empty(nrec.value, dtype=np.int64)
    p = ctypes.c_void_p
    if lib.fasta_read(
        path.encode(), arena.ctypes.data_as(p), starts.ctypes.data_as(p),
        lens.ctypes.data_as(p), names_buf, name_offs.ctypes.data_as(p),
    ):
        return None
    raw = names_buf.raw
    names, seqs = [], []
    for off, st, ln in zip(name_offs.tolist(), starts.tolist(),
                           lens.tolist()):
        names.append(raw[off:raw.index(b"\0", off)].decode())
        seqs.append(arena[st:st + ln].copy())
    return names, seqs


def m8_format(
    qrow: np.ndarray, qarena: bytes, qoff: np.ndarray,
    srow: np.ndarray, sarena: bytes, soff: np.ndarray,
    pident: np.ndarray, length: np.ndarray, mismatch: np.ndarray,
    gapopen: np.ndarray, qs: np.ndarray, qe: np.ndarray,
    ss: np.ndarray, se: np.ndarray, evalue: np.ndarray, bits: np.ndarray,
) -> Optional[bytes]:
    """BLAST-m8 rows in C (report.write_hits's per-row loop; the GIL is
    released during the call): row i names query qrow[i] and subject
    srow[i] from their arenas (name j spans arena[off[j]:off[j + 1]]), then
    the ten numeric columns. Byte-identical to the Python f-strings;
    None without the library."""
    lib = _route("m8_format")
    if lib is None:
        return None
    n = len(qrow)
    if n == 0:
        return b""
    qrow = np.ascontiguousarray(qrow, np.int32)
    srow = np.ascontiguousarray(srow, np.int32)
    qoff = np.ascontiguousarray(qoff, np.int64)
    soff = np.ascontiguousarray(soff, np.int64)
    f8 = lambda a: np.ascontiguousarray(a, np.float64)
    i4 = lambda a: np.ascontiguousarray(a, np.int32)
    i8 = lambda a: np.ascontiguousarray(a, np.int64)
    cols = (f8(pident), i4(length), i4(mismatch), i4(gapopen),
            i8(qs), i8(qe), i8(ss), i8(se), f8(evalue), f8(bits))
    name_bytes = int(
        (qoff[qrow + 1] - qoff[qrow]).sum() + (soff[srow + 1] - soff[srow]).sum()
    )
    out = ctypes.create_string_buffer(name_bytes + 160 * n)
    p = ctypes.c_void_p
    w = lib.m8_format_rows(
        n, qrow.ctypes.data_as(p), qarena, qoff.ctypes.data_as(p),
        srow.ctypes.data_as(p), sarena, soff.ctypes.data_as(p),
        *(c.ctypes.data_as(p) for c in cols), out, len(out),
    )
    if w < 0:
        raise RuntimeError("m8_format_rows: output buffer too small")
    return out.raw[: int(w)]
