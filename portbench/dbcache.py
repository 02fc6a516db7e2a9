"""A configuration's database, made once a checkout, as a user's `db` makes
it, then loaded by every run, as `aln` loads it.

The proteins come from the benchmark's simulator and the configuration's
fixed seed (a deployment's database does not change between samples).
On a cold cache they are written as FASTA to a temporary directory and
indexed by the port's own `db` (`cli.main(["db", ...])`); the index and
the proteins (the raw file the reference reads) go to
`portbench/cache/<config>-<key>/`, `<key>` a hash of the configuration
file, the simulator and the port's index-building sources, so an edit of
either never loads a stale index.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Tuple

import numpy as np

from portbench import simulate

HERE = Path(__file__).resolve().parent
# what `db` runs, relative to the checkout
PORT_SOURCES = ("ghostm_tpu_torch/index", "ghostm_tpu_torch/native.py",
                "ghostm_tpu_torch/csrc/host", "ghostm_tpu_torch/cli.py",
                "ghostm_tpu_torch/io", "ghostm_tpu_torch/ops/encode.py",
                "ghostm_tpu_torch/config.py")


def cache_key(config_path: Path, root: Path) -> str:
    h = hashlib.sha256()
    h.update(Path(config_path).read_bytes())
    h.update((HERE / "simulate.py").read_bytes())
    for rel in PORT_SOURCES:
        p = root / rel
        files = sorted(p.rglob("*")) if p.is_dir() else [p]
        for f in files:
            if f.is_file() and "__pycache__" not in f.parts:
                h.update(str(f.relative_to(root)).encode())
                h.update(f.read_bytes())
    return h.hexdigest()[:16]


def ensure(cell, root: Path) -> Tuple[str, np.ndarray, np.ndarray, float]:
    """(index prefix, protein codes, lengths, seconds spent building; 0 on
    a warm cache)."""
    d = (Path(cell.cache_dir) /
         f"{cell.config['name']}-{cache_key(cell.config_path, root)}")
    if not (d / "ready").exists():
        t0 = time.perf_counter()
        build(cell, d)
        built = time.perf_counter() - t0
    else:
        built = 0.0
    with np.load(d / "proteins.npz") as z:
        codes, lens = z["codes"], z["lens"]
    return str(d / "index"), codes, lens, built


def build(cell, d: Path) -> None:
    """Generate the proteins and run the port's `db` on them into d."""
    from ghostm_tpu_torch import cli

    tmp_dir = d.with_name(d.name + ".building")
    shutil.rmtree(tmp_dir, ignore_errors=True)
    tmp_dir.mkdir(parents=True)
    codes, lens = simulate.database(cell.config["database"])
    np.savez(tmp_dir / "proteins.npz", codes=codes, lens=lens)
    names = [simulate.subject_name(i) for i in range(len(lens))]
    with tempfile.TemporaryDirectory() as t:
        fa = os.path.join(t, "db.fa")
        with open(fa, "wb") as f:
            f.write(simulate.fasta_bytes(codes, lens, names))
        cj = os.path.join(t, "config.json")
        with open(cj, "w") as f:
            json.dump(cell.config["search"], f)
        rc = cli.main(["db", "-i", fa, "-o", str(tmp_dir / "index"),
                       "--config", cj])
        if rc != 0:
            raise RuntimeError(f"db exited {rc}")
    (tmp_dir / "ready").write_text("")
    shutil.rmtree(d, ignore_errors=True)
    os.replace(tmp_dir, d)
