"""Streaming FASTA/FASTQ readers (SURVEY.md §2 "FASTA/FASTQ reader").

Host-side, allocation-light: sequences are yielded as raw bytes and encoded
in batches; the aln path consumes fixed-size read batches (static device
shapes) via `read_batches`.
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, Tuple

import numpy as np

from ghostm_tpu_torch.ops.encode import encode_dna


def _open(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def iter_fasta(path: str) -> Iterator[Tuple[str, bytes]]:
    """Yield (name, sequence_bytes) records. Name is the first token."""
    name = None
    chunks: list[str] = []
    with _open(path) as f:
        first = f.read(1)
        if not first:
            return
        if first == "@":
            yield from _iter_fastq_body(f)
            return
        if first != ">":
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks).encode()
                name = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            else:
                if name is None:  # continuation of the very first header
                    name = line.split()[0]
                    chunks = []
                else:
                    chunks.append(line)
        if name is not None:
            yield name, "".join(chunks).encode()


def _iter_fastq_body(f) -> Iterator[Tuple[str, bytes]]:
    # '@' of the first record already consumed by iter_fasta.
    line = f.readline()
    while True:
        name = line.rstrip().split()[0] if line.strip() else ""
        seq = f.readline().strip()
        f.readline()  # '+'
        f.readline()  # quals
        yield name, seq.encode()
        line = f.readline()
        if not line:
            return
        if not line.startswith("@"):
            raise ValueError("malformed FASTQ")
        line = line[1:]


def read_batches(
    path: str, batch: int, max_len: int
) -> Iterator[Tuple[list, np.ndarray, np.ndarray]]:
    """Yield (names, dna_codes (batch, max_len) int8, lengths (batch,)).

    The final batch is padded up to `batch` rows with empty reads so every
    device step sees an identical static shape (SURVEY.md §7.2).
    """
    names: list[str] = []
    rows = np.full((batch, max_len), 4, dtype=np.int8)  # 4 = N
    lens = np.zeros(batch, dtype=np.int32)

    def flush(n):
        out = (list(names), rows.copy(), lens.copy())
        names.clear()
        rows.fill(4)
        lens.fill(0)
        return out

    n = 0
    for name, seq in iter_fasta(path):
        codes = encode_dna(seq)[:max_len]
        rows[n, : len(codes)] = codes
        lens[n] = len(codes)
        names.append(name)
        n += 1
        if n == batch:
            yield flush(n)
            n = 0
    if n:
        yield flush(n)
