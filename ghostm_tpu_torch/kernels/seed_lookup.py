"""Query k-mer keys for the seed lookup (port of the JAX package's
kernels/seed_lookup.py::query_kmer_keys)."""

from __future__ import annotations

import torch

from ghostm_tpu_torch.index.seeds import NUM_SEED_AA


def query_kmer_keys(qcodes: torch.Tensor, seed_len: int) -> torch.Tensor:
    """(Q, Lq) int32 k-mer keys per query position; windows containing any
    non-seed code (>= 20) or running off the end get the overflow key 20**k
    (whose bucket is empty). Mirrors index.seeds.kmer_keys."""
    Q, Lq = qcodes.shape
    k = seed_len
    nb = NUM_SEED_AA**k
    c = qcodes.to(torch.int32)
    keys = torch.zeros((Q, Lq), dtype=torch.int32, device=c.device)
    valid = torch.ones((Q, Lq), dtype=torch.bool, device=c.device)
    for t in range(k):
        ct = torch.cat([c[:, t:], torch.full((Q, t), NUM_SEED_AA,
                                             dtype=torch.int32,
                                             device=c.device)], dim=1)
        keys = keys * NUM_SEED_AA + ct.clamp(0, NUM_SEED_AA - 1)
        valid &= ct < NUM_SEED_AA
    return torch.where(valid, keys, torch.full_like(keys, nb))
