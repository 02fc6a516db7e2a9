"""Six-frame DNA -> protein translation (SURVEY.md §2 "Six-frame translator").

Translation is a pure LUT — codons index a dense (5,5,5) table (A,C,G,T,N).
Two bit-identical implementations:

  * `six_frame_translate` — numpy host path (test oracle);
  * `six_frame_translate_torch` — device path run at the start of the
    engine's batch step. On the GPU a LUT gather is cheap, so the codon
    lookup and the reverse-complement's per-read anchoring are plain
    gathers (the JAX package's select trees and roll networks exist only
    because the TPU has no vector gather).

Stop codons are KEPT in-frame as AA_STOP codes rather than splitting the
frame into ragged ORFs; hard-stop scoring (ops.scoring.padded_matrix) makes
alignments unable to span a stop, which reproduces split-at-stop behaviour
with static shapes (divergence note: SURVEY.md §7.2 "Ragged everything").
"""

from __future__ import annotations

import numpy as np
import torch

from ghostm_tpu_torch.ops.encode import AA_X, PAD, encode_aa

# Standard genetic code, codon written in DNA (T not U).
_CODON_TABLE = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": "*", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}

_BASE = {"A": 0, "C": 1, "G": 2, "T": 3}

# (5,5,5) codon LUT; any position == 4 (ambiguous N) -> X.
CODON_LUT = np.full((5, 5, 5), AA_X, dtype=np.int8)
for _codon, _aa in _CODON_TABLE.items():
    i, j, k = (_BASE[c] for c in _codon)
    CODON_LUT[i, j, k] = encode_aa(_aa)[0]

# complement for codes A,C,G,T,N -> T,G,C,A,N
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


# Flat 125-entry tables for the device gathers. RC_LUT_FLAT[i] is the
# amino acid of the REVERSE-COMPLEMENT codon read at forward position i:
# RC_LUT[a, b, c] = CODON_LUT[comp(c), comp(b), comp(a)] — so the reverse
# strand translates with a forward scan + reversal, no per-read rc buffer.
CODON_LUT_FLAT = CODON_LUT.reshape(-1)
RC_LUT_FLAT = CODON_LUT[
    _COMP[np.arange(5)][None, None, :, ],
    _COMP[np.arange(5)][None, :, None],
    _COMP[np.arange(5)][:, None, None],
].reshape(-1)


# the two flat LUTs as int8 tensors, by device
_DEVICE_LUTS: dict = {}


def device_luts(dev: torch.device):
    """(CODON_LUT_FLAT, RC_LUT_FLAT) as int8 tensors on `dev`, copied there
    once a device: a copy from host memory cannot be captured into a CUDA
    graph."""
    luts = _DEVICE_LUTS.get(dev)
    if luts is None:
        luts = _DEVICE_LUTS[dev] = tuple(
            torch.from_numpy(t.astype(np.int8)).to(dev)
            for t in (CODON_LUT_FLAT, RC_LUT_FLAT))
    return luts


def six_frame_translate_torch(
    dna: torch.Tensor, lengths: torch.Tensor, frame_len: int
) -> torch.Tensor:
    """Device twin of six_frame_translate: (R, L) int8 codes + (R,) lengths
    on any device -> (R, 6, frame_len) int8 on the same device,
    bit-identical to the host path and to the JAX package's
    six_frame_translate_jnp (tests/test_torch_engine.py). No host memory
    is read: the step's CUDA graph captures it (engine.py)."""
    dev = dna.device
    R, L = dna.shape
    lengths = lengths.to(torch.int64)
    c = dna.to(torch.int64).clamp(0, 4)
    # codon index at every forward position (pad tail with N codons)
    cN = torch.cat([c, torch.full((R, 2), 4, dtype=torch.int64, device=dev)], 1)
    idx = (cN[:, :L] * 5 + cN[:, 1 : L + 1]) * 5 + cN[:, 2 : L + 2]
    fwd_lut, rc_lut = device_luts(dev)
    fwd_aa = fwd_lut[idx]
    rc_aa = rc_lut[idx]
    # reverse strand: Hr[i] = rc_aa[len - 3 - i], written as the JAX
    # package's flip + per-read left roll by (L - len + 2) mod L
    sh = (L - lengths + 2) % L
    pos = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    Hr = torch.gather(rc_aa, 1, (L - 1) - (pos + sh[:, None]) % L)
    ncod_max = min(frame_len, L)
    j = torch.arange(ncod_max, dtype=torch.int64, device=dev)[None, :]
    frames = []
    for src in (fwd_aa, Hr):
        for off in range(3):
            n_cod = min(frame_len, max(0, (L - off) // 3))
            aa = src[:, off : off + 3 * n_cod : 3]
            # floor division, as jnp: (0 - 1) // 3 == -1 keeps j < 0 false
            valid = j[:, :n_cod] < (lengths[:, None] - off) // 3
            aa = torch.where(valid, aa, torch.full_like(aa, PAD))
            out = torch.full((R, frame_len), PAD, dtype=torch.int8, device=dev)
            out[:, :n_cod] = aa
            frames.append(out)
    return torch.stack(frames, dim=1)


def six_frame_translate(
    dna: np.ndarray, lengths: np.ndarray, frame_len: int
) -> np.ndarray:
    """Translate a padded batch of DNA reads in all six frames.

    Args:
      dna: (R, L) int8 codes (A=0..T=3, N=4); padding value irrelevant (masked).
      lengths: (R,) true read lengths.
      frame_len: output residues per frame (pad with PAD / truncate).

    Returns:
      (R, 6, frame_len) int8 amino-acid codes. Frames 0-2 forward offsets
      0,1,2; frames 3-5 are offsets 0,1,2 of the reverse complement.
    """
    dna = np.ascontiguousarray(dna, dtype=np.int8)
    R, L = dna.shape
    lengths = np.asarray(lengths, dtype=np.int64)

    # Reverse-complement with per-read length: rc[r, i] = comp(dna[r, len-1-i])
    pos = np.arange(L, dtype=np.int64)[None, :]
    rc_idx = np.clip(lengths[:, None] - 1 - pos, 0, L - 1)
    rc = _COMP[np.take_along_axis(dna, rc_idx, axis=1)]
    rc[pos >= lengths[:, None]] = 4

    out = np.full((R, 6, frame_len), PAD, dtype=np.int8)
    for strand, seqs in enumerate((dna, rc)):
        for off in range(3):
            n_cod = min(frame_len, max(0, (L - off) // 3))
            if n_cod == 0:
                continue
            c = seqs[:, off : off + 3 * n_cod].reshape(R, n_cod, 3)
            aa = CODON_LUT[
                np.clip(c[..., 0], 0, 4),
                np.clip(c[..., 1], 0, 4),
                np.clip(c[..., 2], 0, 4),
            ]
            valid = np.arange(n_cod)[None, :] < (lengths[:, None] - off) // 3
            aa = np.where(valid, aa, PAD)
            out[:, 3 * strand + off, :n_cod] = aa
    return out
