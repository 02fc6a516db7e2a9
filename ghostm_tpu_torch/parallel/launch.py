"""Starting local ranks: the counterpart of the JAX package's N devices in
one process (`aln --cpu N --data-axis a --db-axis b`), where torch needs a
process a rank.

`run_local` starts the `aln` of one command line as n processes of
`python -m ghostm_tpu_torch`, joined over TCP on a free port of this host;
`start_ranks` / `wait_ranks` do the same for any per-rank command (tests,
chip_smoke.py). A rank that fails fails the run: the others are killed
and its exit code returned.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence

import ghostm_tpu_torch

# the directory holding the package, for the ranks' PYTHONPATH
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    ghostm_tpu_torch.__file__)))


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(env: Optional[dict] = None) -> dict:
    """The environment of a rank: `env` (default os.environ) with the
    package's directory first on PYTHONPATH."""
    env = dict(os.environ if env is None else env)
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = _ROOT + (os.pathsep + path if path else "")
    return env


def start_ranks(cmd_of: Callable[[int, str], Sequence[str]], n: int,
                env: Optional[dict] = None, **popen) -> List[subprocess.Popen]:
    """Start n processes, rank r running cmd_of(r, "127.0.0.1:PORT")."""
    coord = f"127.0.0.1:{free_port()}"
    env = rank_env(env)
    procs = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(list(cmd_of(r, coord)), env=env,
                                          **popen))
    except BaseException:
        kill_ranks(procs)
        raise
    return procs


def kill_ranks(procs: Sequence[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def wait_ranks(procs: Sequence[subprocess.Popen],
               timeout: Optional[float] = None) -> int:
    """Wait for every rank: 0 when all exit 0; else, as soon as one fails,
    the others are killed and the failing rank's code returned (1 for a
    rank ended by a signal). A timeout kills them all and raises
    subprocess.TimeoutExpired."""
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                return bad[0] if bad[0] > 0 else 1
            if all(c == 0 for c in codes):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(procs[0].args, timeout)
            time.sleep(0.02)
    finally:
        kill_ranks(procs)


def run_local(argv: Sequence[str], n: int) -> int:
    """`python -m ghostm_tpu_torch *argv` as n local ranks (--coordinator,
    --num-processes, --process-id and --local-ranks added); returns 0 or
    the first failing rank's exit code."""
    cmd = lambda r, coord: [
        sys.executable, "-m", "ghostm_tpu_torch", *argv,
        "--coordinator", coord, "--num-processes", str(n),
        "--process-id", str(r), "--local-ranks"]
    env = dict(os.environ, LOCAL_WORLD_SIZE=str(n))
    # n ranks share this host's cores (a caller's setting wins)
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n)))
    return wait_ranks(start_ranks(cmd, n, env=env))
