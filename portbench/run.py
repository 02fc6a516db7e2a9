"""The port's benchmark: `aln`'s path on one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cell's GPUs. A run:
  1. makes the traffic pool from --seed (timed apart, not set-up);
  2. finds the configuration's index in portbench/cache/, or builds it
     with the port's `db` (dbcache.py; timed apart, not set-up);
  3. set-up (`setup_s`: process start to here, less 1 and 2): imports,
     CUDA, `load_index`, `SearchEngine` on cuda, two warm batches of the
     cell's own shapes through `run_search` (which build or load the
     kernels they launch);
  4. the window: `pipeline.run_search` over the pool, cycled, until
     --seconds have passed, writing m8 to a file in TMPDIR; closed
     (the pipeline's own one flush thread; no offered rate);
  5. with --trace 1, after the window: the engine step alone with a
     background fetch (64 batches), then 24 pipelined batches under
     torch.profiler; the harness's ranges wrap the engine's
     search_refine_async_dna, propose, align, refine_packed and fetch and
     the pipeline's write_hits;
  6. once the program's state is freed, the reference (reference.py)
     searches a sample of the window's reads drawn from --seed; each
     read's rows must equal the program's. With --control 1 the control
     (the reference with its DP held to 8 bits, SATURATE) stands in the
     program's place for that comparison, and has to come out not
     correct; the benchmark's own runs never pass it.
The last line of standard output is the result's JSON; the numbers
compared, each beside its limit, are the last lines of standard error.
The metrics are read by metrics/<name>.py (spec.py).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


import numpy as np  # noqa: E402

from portbench import check, dbcache, longreads, simulate, spec  # noqa: E402

# a mix's read simulator by its "reads": a window of one protein a read
# (the default), or a window of a genome stretch of several genes
READ_MODELS = {"windows": simulate.reads, "genomes": longreads.reads}
FORBIDDEN = ("jax", "jaxlib", "flax", "ghostm_tpu")
ENGINE_BATCHES = 64          # stretch 2: the step alone
SATURATE = 127               # the control's DP: 8 bits, saturating
# the numbers that decide `correct`, each with its limit
LIMITS = {"reads_differ": 0, "reads_missing": 0}


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(**kw) -> None:
    print(json.dumps(kw), flush=True)


def make_pool(cell, codes, lens, seed: int) -> list:
    """The mix's pool_batches distinct batches from the seed:
    [(names, (batch, max_read_len) int8 DNA, (batch,) int32 lengths)],
    made by the simulator the mix's `reads` names (READ_MODELS)."""
    t = cell.traffic
    P, B = t["pool_batches"], t["batch"]
    model = READ_MODELS[t.get("reads", "windows")]
    dna, rl = model(simulate.rng_for(seed), codes, lens, P * B, t)[:2]
    return [([check.read_name(b, i) for i in range(B)],
             dna[b * B:(b + 1) * B], rl[b * B:(b + 1) * B])
            for b in range(P)]


class Window:
    """The window's feed: the pool, cycled, until `seconds` have passed
    since the first batch was handed over; records which pool batch each
    emission was."""

    def __init__(self, pool: list, seconds: float):
        self.pool, self.seconds = pool, seconds
        self.sequence: list = []
        self.t_open = None

    def __iter__(self):
        i = 0
        while True:
            now = time.perf_counter()
            if self.t_open is None:
                self.t_open = now
            elif now - self.t_open >= self.seconds:
                return
            b = i % len(self.pool)
            self.sequence.append(b)
            yield self.pool[b]
            i += 1


def smi() -> dict:
    """The card's name and power limit (nvidia-smi)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        name, limit = (x.strip() for x in out.split(","))
        return dict(smi_name=name, power_limit=limit)
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return dict(smi_name=None, power_limit=None)


def host_ms() -> float:
    """ms of a fixed piece of pure-Python work, the best of three: the
    host's speed for the interpreter's threads, read beside each run."""
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        x = 0
        for i in range(300_000):
            x += i & 7
        best = min(best, time.perf_counter() - t)
    return best * 1e3


def instrument(engine, records: dict):
    """The harness's spans around the calls into each layer (instance
    attributes over the engine's methods): host seconds of each
    search_refine_async_dna, and record_function ranges named
    portbench.<layer> for the profiler. Returns an undo function."""
    import torch

    from ghostm_tpu_torch import pipeline

    def ranged(name, fn, timed=None):
        @functools.wraps(fn)
        def call(*a, **k):
            t = time.perf_counter()
            with torch.profiler.record_function("portbench." + name):
                out = fn(*a, **k)
            if timed is not None:
                timed.append(time.perf_counter() - t)
            return out
        return call

    engine.search_refine_async_dna = ranged(
        "launch", engine.search_refine_async_dna, records["launch_s"])
    engine.propose = ranged("propose", engine.propose)
    engine.align = ranged("align", engine.align)
    engine.refine_packed = ranged("refine", engine.refine_packed)
    engine.fetch = ranged("flush.fetch", engine.fetch)
    write_hits = pipeline.write_hits
    pipeline.write_hits = ranged("flush.write", write_hits)

    def undo():
        for a in ("search_refine_async_dna", "propose", "align",
                  "refine_packed", "fetch"):
            delattr(engine, a)
        pipeline.write_hits = write_hits
    return undo


def engine_alone(engine, pool: list, n: int) -> dict:
    """The step with the pipeline's background fetch and no writer
    (chip_smoke.timed_run's pattern): n batches, reads over the wall."""
    import torch
    from concurrent.futures import ThreadPoolExecutor

    torch.cuda.synchronize()
    reads = 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as ex:
        fut = pending = None
        for i in range(n):
            names, dna, lens = pool[i % len(pool)]
            pay = engine.search_refine_async_dna(dna, lens)
            if pending is not None:
                if fut is not None:
                    fut.result()
                fut = ex.submit(engine.fetch, pending)
            pending = pay
            reads += len(names)
        if fut is not None:
            fut.result()
        engine.fetch(pending)
    return dict(reads=reads, wall_s=time.perf_counter() - t0)


def profiled(engine, pool: list, n: int, tmp: str) -> dict:
    """n pipelined batches through run_search under torch.profiler (CPU
    and CUDA activity) -> the parsed trace and the launches by shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ghostm_tpu_torch.kernels import _build
    from ghostm_tpu_torch.pipeline import run_search
    from portbench.trace import Trace

    torch.cuda.synchronize()
    _build.reset_launches()
    batches = [pool[i % len(pool)] for i in range(n)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("portbench.window"):
            run_search(engine, iter(batches), os.path.join(tmp, "prof.m8"))
            torch.cuda.synchronize()
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    tr = Trace(path)
    os.remove(path)
    shapes = {}
    for (name, *shp), v in _build.SHAPES.items():
        shapes.setdefault(name, []).append([[list(s) for s in shp], v])
    return dict(trace=tr, shapes=shapes, profiled_batches=n)


def path_check(cell, launches: dict, batches: int) -> list:
    """Faults of the cell's path: a kernel it must launch that did not,
    one it must not that did, one that must run once a batch that did
    not."""
    pc = cell.path_check
    bad = [f"{k} not launched" for k in pc.get("kernels", [])
           if not launches.get(k)]
    bad += [f"{k} launched" for k in pc.get("absent", [])
            if launches.get(k)]
    bad += [f"{k} launched {launches.get(k)} times in {batches} batches"
            for k in pc.get("once_a_batch", [])
            if launches.get(k) != batches]
    return bad


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", engine_hook=None,
             control: bool = False) -> dict:
    """One run of the cell; returns the result (the last line's object)
    with the earlier lines' records under "_records". engine_hook: a
    function applied to the engine before the window (the tests plant
    faults with it). control: the control's rows stand in the program's
    place in the comparison."""
    import torch

    from ghostm_tpu_torch.config import Config
    from ghostm_tpu_torch.engine import SearchEngine
    from ghostm_tpu_torch.index.diskio import load_index
    from ghostm_tpu_torch.kernels import _build
    from ghostm_tpu_torch.pipeline import run_search
    from ghostm_tpu_torch.utils.logging import setup_logging
    from ghostm_tpu_torch.utils.metrics import MetricsLog

    cuda = device == "cuda"
    card = smi() if cuda else {}
    if cuda:
        log(phase="device", **card, torch=torch.__version__,
            cuda=torch.version.cuda)
    records: dict = {}
    t = time.perf_counter()
    prefix, codes, lens, built_s = dbcache.ensure(cell, ROOT)
    db_s = time.perf_counter() - t
    t = time.perf_counter()
    pool = make_pool(cell, codes, lens, seed)
    pool_s = time.perf_counter() - t
    log(phase="inputs", workload=cell.name, seed=seed, pool_s=pool_s,
        pool_reads=sum(len(p[0]) for p in pool), index_build_s=built_s,
        index_cache_s=db_s)
    setup_logging()                      # as `aln` logs
    index = load_index(prefix)
    cfg = Config(**cell.search_config())
    if cfg.seed_len != index.seed_len:
        raise ValueError("the cached index has another seed length")
    engine = SearchEngine(cfg, index, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        run_search(engine, iter(pool[:2]), os.path.join(tmp, "warm.m8"))
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - T_START - db_s - pool_s
        layout = dict(table_mode=engine.table_mode, shards=engine.n_shards,
                      presorted_run=engine.presorted_run)
        log(phase="setup", setup_s=setup_s, route=engine.route,
            merged_colocated=engine.merged_colocated, **layout)
        if engine_hook is not None:
            engine_hook(engine)
        _build.reset_launches()
        mlog = MetricsLog()
        win = Window(pool, seconds)
        out = os.path.join(tmp, "window.m8")
        records.update(launch_s=[], setup_s=setup_s,
                       cfg=cell.search_config(), layout=layout)
        undo = instrument(engine, records) if trace else None
        rows = error = None
        cpu0 = sum(os.times()[:2])
        try:
            rows = run_search(engine, win, out, metrics=mlog)
        except Exception as e:           # a failed batch fails the run
            traceback.print_exc()
            error = f"{type(e).__name__}: {e}"
        t_close = time.perf_counter()
        cpu1 = sum(os.times()[:2])
        if cuda:
            torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        attempted = len(win.sequence) * cfg.query_batch
        written = sum(b.reads for b in mlog.batches)
        records.update(
            window_s=t_close - (win.t_open or t_close),
            reads_written=written, rows=rows,
            batches=[vars(b) for b in mlog.batches],
            peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0)
        faults = path_check(cell, launches, len(win.sequence)) if cuda \
            else []
        split = {k: 1e3 * float(np.mean([getattr(b, k) for b in
                                          mlog.batches]))
                 for k in ("fetch_s", "columns_s", "format_s", "write_s")
                 } if mlog.batches else {}
        log(phase="window", batches=len(win.sequence), reads=attempted,
            rows=rows, window_s=records["window_s"], launches=launches,
            path_faults=faults, out_bytes=os.path.getsize(out)
            if os.path.exists(out) else 0, error=error,
            flush_ms=split, proc_cores=(cpu1 - cpu0) / max(
                records["window_s"], 1e-9), host_ms=host_ms())
        # the window's launch times; the later stretches' go elsewhere
        records["launch_s"] = list(records["launch_s"])
        if trace and error is None:
            records["engine"] = engine_alone(engine, pool, ENGINE_BATCHES)
            records.update(profiled(engine, pool,
                                    cell.traffic["trace_batches"], tmp))
            undo()
        elif undo is not None:
            undo()
        dev = dict(platform="gpu" if cuda else "cpu",
                   kind=torch.cuda.get_device_name(0) if cuda else "cpu",
                   count=cell.chips,
                   memory_peak_bytes=int(records["peak_bytes"]), **card)
        if trace and "trace" in records:
            tr = records["trace"]
            dev.update(busy_s=tr.busy_us() * 1e-6,
                       window_s=tr.window_us() * 1e-6)
        # the program's state goes before the reference runs
        del engine, index
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        wanted = check.sample(seed, len(win.sequence), cfg.query_batch,
                              cell.traffic["check_reads"])
        if control:
            got = check.reference_rows(pool, wanted, win.sequence, codes,
                                       lens, cell.search_config(), device,
                                       saturate=SATURATE)
        elif error is None and os.path.exists(out):
            try:
                got = check.program_rows(out, win.sequence, wanted)
            except (ValueError, IndexError) as e:
                got, error = {}, f"unreadable output: {e}"
        else:
            got = {}
        want = check.reference_rows(pool, wanted, win.sequence, codes, lens,
                                    cell.search_config(), device)
        cmp = check.compare(got, want)
        checks = {"reads_differ": cmp["reads_differ"],
                  "reads_missing": attempted - written}
        log(phase="check", sampled=len(wanted), rows_checked=cmp[
            "rows_checked"], reference_s=time.perf_counter() - t,
            first_differ=cmp["first_differ"])
    correct = (error is None and not faults
               and all(checks[k] <= LIMITS[k] for k in LIMITS))
    metrics = spec.read_metrics(cell.metrics(trace), records)
    result = dict(correct=correct, attempted=attempted,
                  failed=attempted - written, metrics=metrics, device=dev)
    if trace and "trace" in records:
        tr = records["trace"]
        result["breakdown"] = dict(device_ops=tr.top_ops(),
                                   idle_gaps=tr.idle_gaps())
    result["checks"] = {k: dict(value=checks[k], limit=LIMITS[k])
                        for k in LIMITS}
    result["_records"] = records
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="the control in the program's place (its "
                    "readings; never a benchmark run)")
    args = ap.parse_args(argv)
    cell = spec.Cell(ROOT / "BENCHMARK.json", args.workload)
    # every build and kernel cache at a fixed place inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / "build" / sub)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"have {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      control=bool(args.control))
    result.pop("_records")               # "checks" is now the last key
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded after the window: {bad}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
