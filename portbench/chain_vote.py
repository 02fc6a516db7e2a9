"""Kernel R2, the chained vote of long-read mode (the port's
csrc/chain_vote.cu, wrapper `chain_vote_rank_rows`): its device time and
its share of its roofline in a traced run. Where the program has no such
kernel (a trace with no launch of it, or no launch counted), both read
nothing.

Counts, in roofline.py's conventions (every input byte read once, every
output byte written once; a logical count of int32 operations against the
non-tensor 32-bit rate): a launch on (Q, M) keys with ncand candidates a
row reads the Q x M int32 keys and writes ncand keys and ncand votes a
row. Its operations are OPS_PER_KEY a key:
- run detection, 4: the key against the one before and the one after, and
  against its subject row's two ends (a row starts a new chain);
- the chain recurrence, 8: the element gamma * key + 1 (2), then the
  recurrence's add and max (2), once composed into the thread's prefix
  and once stepped again from the scanned state (2 x 4, the select of a
  reset included);
- the run's score, 4: at a run start the clamp term (a subtraction and a
  max), at its end the length and the score (two adds), amortized as one
  each a key;
and the top-ncand insertion's compare is left out, like the scans'
shuffles (a few a 16 keys). At the long-read cell's (128, 441,856)
rows and 4 candidates: 226.2 MB in (67.5 us at 3.35 TB/s) against 905 M
operations (13.5 us at 67 T/s), so bytes bound. The bytes are the whole
row's: the kernel loads the invalid tail too (a thread whose first key is
invalid loads its keys and scores nothing). About 46% of the cell's keys
are valid (3 launches at seed 3023000234 on an H100), so a kernel that
stopped at the valid prefix would have about half these bytes to read,
and this share would read about half as high for the same time.
"""

from __future__ import annotations

import re
from typing import Tuple

from portbench import readers, roofline

KERNEL = re.compile(r"\bchain_vote_kernel\b")
WRAPPER = "chain_vote_rank_rows"
OPS_PER_KEY = 16


def counts(Q: int, M: int, ncand: int) -> Tuple[int, int]:
    """(bytes, operations) of one launch on a (Q, M) key array."""
    return Q * M * 4 + 2 * Q * ncand * 4, OPS_PER_KEY * Q * M


def device_ms(rec):
    """Device ms a batch of R2's launches in the profiled stretch, found
    by the kernel's name."""
    tr = rec.get("trace")
    if tr is None or not tr.window_us():
        return None
    durs = tr.kernel_durations(KERNEL)
    return sum(durs) / rec["profiled_batches"] * 1e-3 if durs else None


def roofline_share(rec):
    """100 x R2's launches' least time at their (Q, M) and the candidates
    a frame over their device time (readers._share)."""
    ncand = rec.get("cfg", {}).get("candidates_per_frame")
    if ncand is None:
        return None
    return readers._share(rec, WRAPPER, KERNEL, lambda s: roofline.bound(
        *counts(s[0], s[1], ncand))[0])
