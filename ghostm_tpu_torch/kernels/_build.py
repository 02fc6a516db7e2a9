"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` into its own shared library with a plain
C interface and loaded with ctypes (no PyTorch headers: a build takes
seconds, where torch.utils.cpp_extension takes minutes). Libraries are
built at first use into `<checkout>/build/kernels/`, named by a hash of
the source, its headers and the flags, so an edited source rebuilds and an
unchanged one loads at once. `build_all` compiles every source in
parallel (one nvcc process each).

Nothing here runs at import time: the CPU tests import every module on a
host without nvcc or a GPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("sort_rows", "sort_vote", "merge_vote", "sw_fused", "lex_rank",
           "sw_scored", "refine", "chain_vote")
# Compile-time constants of a source that its wrapper plans launches with,
# defined here once and passed to nvcc as -D<name>=<value>. sort_rows: B1's
# k-way merge takes at most KWAY_MAX runs, KWAY_SAMPLES samples a run and
# KWAY_SMEM bytes of shared memory a block (an H100 block's opt-in limit).
DEFINES: Dict[str, Dict[str, int]] = {
    "sort_rows": {"KWAY_MAX": 32, "KWAY_SAMPLES": 256,
                  "KWAY_SMEM": 227 << 10},
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

# Launch counts, one per kernel wrapper: a wrapper adds one where it
# launches its kernel and nowhere else (a CPU tensor's plain version does
# not count), so a run can show that its path went through the kernels; a
# replayed CUDA graph adds the launches its capture recorded (Replayed).
# SHAPES counts the same launches by (wrapper, input shapes). B1's long rows
# count their stages: "sort_rows_tiles" the tile sort, "sort_rows_merge"
# each merge launch (a pairwise pass, or the k-way merge), and
# "sort_rows_kway" the k-way merges among those, by (Q, M, K).
LAUNCHES: Dict[str, int] = dict.fromkeys((
    "sort_rows", "sort_rows_tiles", "sort_rows_merge", "sort_rows_kway",
    "sort_vote_rank_rows",
    "merge_vote_rank_rows", "sw_fused", "lex_rank_rows", "sw_scored",
    "sw_wave", "refine", "chain_vote_rank_rows",
), 0)
SHAPES: Counter = Counter()


def count(name: str, *shapes) -> None:
    """One launch of `name` on inputs of `shapes`."""
    LAUNCHES[name] += 1
    SHAPES[(name, *(tuple(s) for s in shapes))] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SHAPES.clear()


def _add_counts(launches: Counter, shapes: Counter, sign: int) -> None:
    for k, v in launches.items():
        LAUNCHES[k] += sign * v
    for k, v in shapes.items():
        SHAPES[k] += sign * v
        if not SHAPES[k]:
            del SHAPES[k]


class Replayed:
    """A captured CUDA graph and the kernel launches its capture recorded.
    A capture runs nothing, so the launches counted while `recording` are
    taken back out of LAUNCHES and SHAPES; every `replay` adds them again,
    so the counts say what the device ran, as on the eager path. `graph`
    is anything with a replay() (torch.cuda.CUDAGraph)."""

    def __init__(self, graph):
        self.graph = graph
        self.launches: Counter = Counter()
        self.shapes: Counter = Counter()

    @contextlib.contextmanager
    def recording(self):
        launches0, shapes0 = Counter(LAUNCHES), Counter(SHAPES)
        try:
            yield self
        finally:
            self.launches = Counter(LAUNCHES) - launches0
            self.shapes = SHAPES - shapes0
            _add_counts(self.launches, self.shapes, -1)

    def replay(self) -> None:
        self.graph.replay()
        _add_counts(self.launches, self.shapes, 1)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{k}={v}"
                              for k, v in DEFINES.get(name, {}).items())


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(_flags(name)).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source (returns None when already built)."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Compile every kernel source in parallel; returns each nvcc log
    (the -Xptxas -v register/shared-memory report), "" when cached."""
    with _lock:
        started = {n: _start(n) for n in SOURCES}
        return {n: _finish(n, s) for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def check(err: int, kernel: str) -> None:
    """Raise on a non-zero cudaError_t returned after a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError_t {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
