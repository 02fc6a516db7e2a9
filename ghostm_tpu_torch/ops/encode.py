"""Alphabet encoders: residue characters -> small integer codes.

TPU-native choice: all encoders are 256-entry LUTs applied with
``np.frombuffer`` + fancy indexing (vectorised, no Python loop), emitting
``int8`` buffers that pack densely into HBM and index directly into the
substitution matrix (SURVEY.md §2 "Alphabet encoder").

Amino-acid code space (24 live codes, NCBI BLOSUM order) plus:
  - code 23: '*' stop codon (scored by the matrix; hard-stop mode overrides)
  - AA_X = 22: 'X'/unknown (also target of ambiguous DNA translation)
  - SENTINEL = 24: inter-subject separator in the concatenated DB buffer;
    never forms a valid seed and scores SENTINEL_SCORE vs everything, so SW
    extension cannot profitably cross a subject boundary.
  - PAD = 25: query padding; same scoring treatment as SENTINEL.
"""

from __future__ import annotations

import numpy as np

# NCBI standard 24-letter protein alphabet order (matches BLOSUM62 table).
AA_ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX*"
AA_X = AA_ALPHABET.index("X")          # 22
AA_STOP = AA_ALPHABET.index("*")       # 23
SENTINEL = 24                          # DB inter-subject separator
PAD = 25                               # query padding
NUM_AA_CODES = 26                      # size of the scoring code space
ALPHA = 32                             # padded code-space for TPU-friendly LUTs

DNA_ALPHABET = "ACGT"
DNA_N = 4                              # any ambiguous nucleotide

_aa_lut = np.full(256, AA_X, dtype=np.int8)
for _i, _c in enumerate(AA_ALPHABET):
    _aa_lut[ord(_c)] = _i
    _aa_lut[ord(_c.lower())] = _i
# Common extended codes mapped onto the 24-letter space:
_aa_lut[ord("U")] = _aa_lut[ord("u")] = AA_ALPHABET.index("C")  # selenocysteine
_aa_lut[ord("O")] = _aa_lut[ord("o")] = AA_ALPHABET.index("K")  # pyrrolysine
_aa_lut[ord("J")] = _aa_lut[ord("j")] = AA_ALPHABET.index("L")  # I/L ambiguous

_dna_lut = np.full(256, DNA_N, dtype=np.int8)
for _i, _c in enumerate(DNA_ALPHABET):
    _dna_lut[ord(_c)] = _i
    _dna_lut[ord(_c.lower())] = _i


def encode_aa(seq: str | bytes) -> np.ndarray:
    """Protein string -> int8 codes in [0, 24); unknown chars -> X."""
    b = seq.encode() if isinstance(seq, str) else seq
    return _aa_lut[np.frombuffer(b, dtype=np.uint8)]


def encode_dna(seq: str | bytes) -> np.ndarray:
    """DNA string -> int8 codes A,C,G,T=0..3; anything else -> 4 (N)."""
    b = seq.encode() if isinstance(seq, str) else seq
    return _dna_lut[np.frombuffer(b, dtype=np.uint8)]


def decode_aa(codes: np.ndarray) -> str:
    table = np.array(list(AA_ALPHABET + "$."), dtype="U1")  # 24:'$' 25:'.'
    return "".join(table[np.asarray(codes, dtype=np.int64)])
