"""The profiled stretch's Chrome trace, reduced to what the readers need.

torch.profiler's trace holds the device's operations (kernels, copies,
sets) with their device times, the runtime calls that launched them
(joined by correlation id), and the harness's `record_function` ranges on
the host threads (`portbench.*`). The window runs from the first
`portbench.launch` to the end of `portbench.window`. Each device
operation is put under the innermost harness range open on the launching
thread when it was launched; each idle stretch of the device under the
innermost range open on any thread at its middle (the main thread's
first).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "portbench."


class Trace:
    def __init__(self, path: str, window_range: str = "portbench.window"):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.ops: List[dict] = []            # device ops, time order
        launches: Dict[int, Tuple[int, float]] = {}
        ranges: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
        self.window: Optional[Tuple[float, float]] = None
        main_tid = None
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.ops.append(dict(name=name, ts=ts, dur=dur,
                                     corr=ev.get("args", {}).get(
                                         "correlation")))
            elif cat in ("cuda_runtime", "cuda_driver"):
                c = ev.get("args", {}).get("correlation")
                if c is not None:
                    launches[c] = (ev.get("tid"), ts)
            elif cat == "user_annotation" and name.startswith(PREFIX):
                ranges[ev.get("tid")].append(
                    (ts, ts + dur, name[len(PREFIX):]))
                if name == window_range:
                    self.window = (ts, ts + dur)
                    main_tid = ev.get("tid")
        self.ops.sort(key=lambda o: o["ts"])
        self.ranges = ranges
        self.main_tid = main_tid
        # the window opens at the first batch's launch: run_search's own
        # set-up (the subject-name map) before it is no batch's work
        first = [a for a, _, n in ranges.get(main_tid, ()) if n == "launch"]
        if self.window is not None and first:
            self.window = (min(first), self.window[1])
        for o in self.ops:
            tid, ts = launches.get(o["corr"], (None, None))
            o["range"] = (self._innermost(tid, ts) if tid is not None
                          else None)

    def _innermost(self, tid, ts: float) -> Optional[str]:
        best = None
        for a, b, name in self.ranges.get(tid, ()):
            if a <= ts <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return None if best is None else best[2]

    def in_window(self) -> List[dict]:
        if self.window is None:
            return []
        a, b = self.window
        return [o for o in self.ops if o["ts"] < b and o["ts"] + o["dur"] > a]

    def busy_us(self) -> float:
        """The union of the device ops' intervals inside the window."""
        if self.window is None:
            return 0.0
        a, b = self.window
        busy, end = 0.0, a
        for o in self.in_window():
            s, e = max(o["ts"], end), min(o["ts"] + o["dur"], b)
            if e > s:
                busy += e - s
                end = e
        return busy

    def window_us(self) -> float:
        return 0.0 if self.window is None else self.window[1] - self.window[0]

    def device_us(self, range_name: str) -> float:
        """Device time of the ops launched under a harness range."""
        return sum(o["dur"] for o in self.in_window()
                   if o["range"] == range_name)

    def kernel_durations(self, pattern) -> List[float]:
        """Device times (us) of each op whose name matches `pattern` (a
        compiled regular expression), in the window."""
        return [o["dur"] for o in self.in_window()
                if pattern.search(o["name"])]

    def top_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = defaultdict(float)
        for o in self.in_window():
            tot[o["name"]] += o["dur"]
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:160], v * 1e-6] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The n longest stretches in the window with no device op, each
        under the harness range open on the host at its middle."""
        if self.window is None:
            return []
        a, b = self.window
        gaps, end = [], a
        for o in self.in_window():
            if o["ts"] > end:
                gaps.append((o["ts"] - end, end, o["ts"]))
            end = max(end, o["ts"] + o["dur"])
        if b > end:
            gaps.append((b - end, end, b))
        gaps.sort(reverse=True)
        out = []
        for g, s, e in gaps[:n]:
            mid = (s + e) / 2
            label = self._innermost(self.main_tid, mid)
            if label in (None, "window"):
                other = [self._innermost(t, mid) for t in self.ranges
                         if t != self.main_tid]
                other = [x for x in other if x]
                label = other[0] if other else ("wait" if label else "host")
            out.append([label, g * 1e-6])
        return out
