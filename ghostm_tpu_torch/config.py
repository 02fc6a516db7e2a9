"""Frozen configuration for the whole pipeline.

Reference parity: GHOSTM's CLI exposes seed length, candidate limits, scoring
matrix, gap penalties and output limits (SURVEY.md §5.6 — family convention;
the reference mount was empty, see SURVEY.md §0). Every reference-visible knob
is a field here so agreement runs can mirror reference settings exactly.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Config:
    """All tunables for index build + search. Defaults target short
    (~100 bp) metagenomic reads vs a protein DB, GHOSTM's design point."""

    # --- seeding (SURVEY.md §1.1 step 3) ---
    # k — amino-acid k-mer length of the seed index. SCALE WITH DB SIZE:
    # there are 20**k buckets and hits_per_seed caps each one, so total
    # retained seed positions <= 20**k * hits_per_seed. k=3 suits toy/test
    # DBs (<~1M residues); use k=4 for ~10-100M residues and k=5 for
    # SwissProt/nr scales, raising hits_per_seed to 64-256.
    seed_len: int = 3
    # Per-k-mer bucket cap, applied GLOBALLY at `db` build time (before
    # sharding) in (subject id, offset) order — the deterministic overflow
    # policy that keeps results invariant to shard layout (SURVEY.md §7.2).
    # Query-time expansion is lossless (index records its max bucket width).
    hits_per_seed: int = 16
    min_votes: int = 1           # min seed hits on a diagonal bin to be a candidate
    candidates_per_frame: int = 8  # top-N candidate regions kept per query frame
    # Long-read chaining approximation (SURVEY.md §5.7): also credit each
    # diagonal bin with its +-1 neighbours' votes before ranking, so seed
    # hits drifting across bins (indels over kbp-scale queries) still
    # concentrate on one candidate band. Off by default for short reads.
    smooth_bins: bool = False
    # Collinear chaining (SURVEY.md §5.7, config 5): > 0 ranks candidates
    # by chain score — votes accumulated along same-subject diagonal runs
    # with a drift penalty of chain_gamma votes per bin — instead of raw
    # per-bin votes. The long-read mode's band-center selector; leave 0
    # for short reads. gamma must EXCEED the expected noise votes per
    # (subject, bin) cell (~ Lq * expand / (subjects * nbins)) or chains
    # profitably run away through noise — with seed_len >= 4 noise is
    # well below 1 and gamma 1-4 is safe. (kernels/candidates.py chain DP.)
    chain_gamma: int = 0

    # --- alignment (SURVEY.md §1.1 step 4) ---
    band_width: int = 32         # banded SW band (diagonal span), multiple of 8
    gap_open: int = 11           # affine gap open penalty (positive)
    gap_extend: int = 1          # affine gap extend penalty (positive)
    matrix: str = "BLOSUM62"     # any key of ops.scoring.MATRICES

    # --- query handling ---
    query_frame_len: int = 40    # max residues per translated frame (pad/truncate);
                                 # 100 bp reads -> ceil(100/3)=34 aa
    query_batch: int = 4096      # reads per device batch (static shape)

    # --- reporting (SURVEY.md §1.1 step 5) ---
    max_hits: int = 10           # top-k reported alignments per read
    evalue_cutoff: float = 10.0
    # Karlin-Altschul gapped params: None -> looked up from the published
    # NCBI table by (matrix, gap_open, gap_extend) (ops/evalue.py, which
    # REJECTS combinations with no published fit). Explicit values override
    # (e.g. to mirror a reference run's constants).
    ka_lambda: Optional[float] = None
    ka_k: Optional[float] = None
    ka_h: Optional[float] = None

    # --- index build ---
    shards: int = 1              # DB shards written by `db` mode
    # Sentinel residues between subjects (>= seed_len so k-mers never span a
    # boundary). Alignment containment does NOT rely on this: the engine
    # masks substitution scores outside the candidate subject's span
    # (engine.align_shard), so windows overlapping neighbours cannot leak.
    sentinel_pad: int = 8

    # --- distribution (SURVEY.md §2.1) ---
    data_axis: int = 1           # mesh size along "data" (query DP)
    db_axis: int = 1             # mesh size along "db" (index sharding)

    # --- observability (SURVEY.md §5.1, §5.5) ---
    profile_dir: Optional[str] = None
    log_json: bool = False
    check: bool = False          # checkify debug mode (SURVEY.md §5.2)
    checkpoint_batches: int = 0  # >0: write per-batch result parts + cursor

    def __post_init__(self):
        if self.band_width % 8 != 0:
            raise ValueError("band_width must be a multiple of 8 (TPU sublane)")
        if self.seed_len < 2 or self.seed_len > 5:
            raise ValueError("seed_len must be in [2, 5]")
        if self.sentinel_pad < self.seed_len:
            raise ValueError("sentinel_pad must be >= seed_len")
        self.ka_params()  # reject unknown (matrix, gap) combos early

    def ka_params(self):
        """(lambda, K, H) — explicit fields win, else the published NCBI
        table (ValueError for unknown (matrix, gap_open, gap_extend))."""
        if self.ka_lambda is not None and self.ka_k is not None:
            return self.ka_lambda, self.ka_k, self.ka_h or 0.0
        from ghostm_tpu_torch.ops.evalue import params_for

        return params_for(self.matrix, self.gap_open, self.gap_extend)

    @classmethod
    def from_json(cls, path: str, **overrides) -> "Config":
        with open(path) as f:
            d = json.load(f)
        d.update(overrides)
        return cls(**d)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)
