"""The ("data", "db") grid of ranks (port of the JAX package's
parallel/mesh.py).

JAX drives a device mesh from one process; torch has one rank a process.
A Mesh here is the rank's place among the `data * db` ranks of the default
process group: rank r sits at data row r // db and db column r % db, as
`np.array(devices).reshape(data, db)` lays devices out in the JAX
package. Query batches ride "data": each data row takes a contiguous block
of a batch's reads. Index shards ride "db": column j holds shard j. A rank
is in one "db" group (its data row: the ranks that hold every shard) and
one "data" group (its db column); an axis of size 1 has no group, and a
collective over it is the identity.

Backends: gloo for CPU tensors; on CUDA, NCCL when every rank of the node
has a card of its own, else gloo (NCCL refuses two ranks on one device).
This torch's gloo takes CUDA tensors for all_gather and all_reduce (it
stages them through the host itself), so the collectives are handed the
device tensors either way.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

log = logging.getLogger("ghostm_tpu_torch.parallel")

DATA_AXIS = "data"
DB_AXIS = "db"
# A collective that waits longer than this for a peer fails (gloo's own
# default is 30 minutes); GHOSTM_TPU_DIST_TIMEOUT overrides it (seconds).
DEFAULT_TIMEOUT_S = 300.0


def check_grid(data: int, db: int, have: int) -> None:
    """The JAX package's refusal of a mesh larger than its devices."""
    need = data * db
    if have < need:
        raise ValueError(f"mesh ({data}x{db}) needs {need} devices, "
                         f"have {have}")


def choose_backend(device: torch.device, local_ranks: int) -> str:
    """NCCL for CUDA ranks that each have a card of their own on the
    node, else gloo."""
    if (device.type == "cuda" and dist.is_nccl_available()
            and local_ranks <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def rank_device(device: str, rank: int) -> torch.device:
    """The device of a rank: the CPU when asked for, else
    cuda:{local_rank % cards} (LOCAL_RANK where a launcher sets it, else
    the rank)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_distributed(coordinator: Optional[str], num_processes: Optional[int],
                     process_id: Optional[int], backend: Optional[str] = None,
                     device: str = "cpu") -> Optional[str]:
    """Join the default process group as rank `process_id` of
    `num_processes` over tcp://`coordinator`; a no-op for one process (the
    JAX package's rule). backend None: choose_backend for `device`, with
    LOCAL_WORLD_SIZE (else every rank) as the ranks of this node. The
    group's timeout (DEFAULT_TIMEOUT_S, or GHOSTM_TPU_DIST_TIMEOUT) fails
    a collective whose peer is gone. Returns the backend, or None when
    nothing was joined."""
    if not num_processes or num_processes <= 1:
        return None
    if not coordinator:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "(--coordinator host:port)")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in "
                         f"[0, {num_processes})")
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
        backend = choose_backend(torch.device(device), local)
    timeout = float(os.environ.get("GHOSTM_TPU_DIST_TIMEOUT",
                                   DEFAULT_TIMEOUT_S))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))
    log.info("rank %d of %d joined tcp://%s (%s, timeout %.0f s)",
             process_id, num_processes, coordinator, backend, timeout)
    return backend


class Mesh:
    """One rank's place in the (data, db) grid and its process groups
    (make_mesh). local_ranks: the ranks were started by one CLI run
    (launch.run_local), the counterpart of the JAX package's one-process
    mesh: rank 0 alone writes the table. time_collectives: synchronise the
    device around each collective and add its seconds to `collective_s`
    under the collective's name (the step's: "select", "merge",
    "windows"; search_batch_stats's "rows")."""

    def __init__(self, data: int, db: int, rank: int = 0,
                 backend: Optional[str] = None, local_ranks: bool = False):
        self.data, self.db, self.rank = data, db, rank
        self.backend = backend
        self.local_ranks = local_ranks
        self.data_index, self.db_index = divmod(rank, db)
        self.groups: Dict[str, object] = {DATA_AXIS: None, DB_AXIS: None}
        self.time_collectives = False
        self.collective_s: Dict[str, float] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, DB_AXIS: self.db}

    @contextlib.contextmanager
    def _timed(self, name: str, x: torch.Tensor):
        if not self.time_collectives:
            yield
            return
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        yield
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        self.collective_s[name] = (self.collective_s.get(name, 0.0)
                                   + time.perf_counter() - t0)

    def all_gather(self, x: torch.Tensor, axis: str,
                   name: str) -> torch.Tensor:
        """(n, *x.shape): every rank's x along `axis`, in grid order.
        name: the collective's key in collective_s."""
        n = self.shape[axis]
        if n == 1:
            return x[None]
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(n)]
        with self._timed(name, x):
            dist.all_gather(out, x, group=self.groups[axis])
        return torch.stack(out)

    def all_reduce_sum(self, x: torch.Tensor, axis: str,
                       name: str) -> torch.Tensor:
        """x summed over `axis` (in place; x is returned)."""
        if self.shape[axis] > 1:
            with self._timed(name, x):
                dist.all_reduce(x, op=dist.ReduceOp.SUM,
                                group=self.groups[axis])
        return x


def make_mesh(data: int, db: int, local_ranks: bool = False) -> Mesh:
    """This rank's Mesh over the default process group, or a one-rank
    mesh (1x1) without one. Raises the JAX package's ValueError when the
    group has fewer than data * db ranks (and one when it has more: every
    rank must hold a place). Every rank creates every group, in the same
    order, as torch requires."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    check_grid(data, db, world)
    if world > data * db:
        raise ValueError(f"mesh ({data}x{db}) takes {data * db} ranks, the "
                         f"process group has {world}")
    if not initialized:
        return Mesh(data, db, local_ranks=local_ranks)
    mesh = Mesh(data, db, dist.get_rank(), dist.get_backend(), local_ranks)
    if db > 1:
        for row in range(data):
            g = dist.new_group([row * db + j for j in range(db)])
            if row == mesh.data_index:
                mesh.groups[DB_AXIS] = g
    if data > 1:
        for col in range(db):
            g = dist.new_group([i * db + col for i in range(data)])
            if col == mesh.db_index:
                mesh.groups[DATA_AXIS] = g
    log.info("mesh (%dx%d): rank %d at data row %d, db column %d (%s)",
             data, db, mesh.rank, mesh.data_index, mesh.db_index,
             mesh.backend)
    return mesh
