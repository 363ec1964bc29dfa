"""A profiled stretch of the measured window, reduced to what the
per-layer metrics read: device intervals and their union, device time by
kernel name and by class, the idle gaps labelled by what the host was
doing, and the benchmark's own spans.

The profiler's Chrome trace is written to a temporary file, read once and
deleted: only the reduction is kept."""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
import threading
import time
from collections import defaultdict

import torch

MARKER = "spin_kernel"      # torch.cuda._sleep's kernel, launched at both ends
START_CYCLES, END_CYCLES = 1000, 40000   # the two markers' spins: ~0.5 and ~20 us
END_MARK_US = 8.0           # a marker that ran this long or longer is the end's
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SETTLE_S = 0.2              # wait after the profiler's start and after the end marker
PAD_KERNELS = 64            # kernels launched after the end marker, before the stop

# the __global__ functions of the port's csrc/ (its hand-written kernels)
PORT_KERNELS = re.compile(r"\b(conv|banded_corr|corr_unfold|scale|roll|row_gather|"
                          r"swin_attn|swin_block|swin_mlp)_kernel\b")


def kernel_class(name: str) -> str:
    """One of: port kernels, convolutions, matmuls, elementwise (with
    reductions and copies)."""
    low = name.lower()
    if PORT_KERNELS.search(name):
        return "port kernels"
    if any(t in low for t in ("fprop", "dgrad", "wgrad", "cudnn", "conv")):
        return "convolutions"
    if any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmuls"
    return "elementwise"


def short_name(name: str, n: int = 80) -> str:
    """A kernel's name without its return type, anonymous namespaces,
    template arguments and parameter list."""
    base = name.replace("(anonymous namespace)::", "")
    base = re.sub(r"^void ", "", base)
    base = re.split(r"[<(]", base)[0].strip()
    return (base or name)[:n]


def union(intervals):
    """Merged [start, end) intervals of a list of (start, end)."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Tracer:
    """torch.profiler (device activity only, so the host is not slowed by
    recording its operations) over a stretch of the window: start() and
    stop() inside it, summarize() after it. The benchmark's own spans
    around its calls into the program are kept on the host clock while
    tracing (`span`); a marker kernel launched on an idle card at both
    ends ties the host clock to the trace's."""

    def __init__(self):
        self.prof = None
        self.active = False
        self.spans = []
        self.h0 = self.h1 = 0.0

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        t = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t, time.perf_counter(),
                               threading.get_ident() == threading.main_thread().ident))

    def warm(self) -> None:
        """Start and stop the profiler once, so that its one-time
        initialisation is paid in set-up, not in the window."""
        self.start()
        self.stop()
        self.prof = None

    def _mark(self, cycles: int) -> float:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            t = time.perf_counter()
            torch.cuda._sleep(cycles)
            return t
        return time.perf_counter()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        self.prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                        else ProfilerActivity.CPU])
        self.prof.start()
        if cuda:                # the device recording starts after start() returns
            time.sleep(SETTLE_S)
        self.spans = []
        self.h0 = self._mark(START_CYCLES)
        self.active = True

    def stop(self) -> None:
        self.active = False
        self.h1 = self._mark(END_CYCLES)
        if torch.cuda.is_available():
            # the last kernels' records reach the profiler after they ran:
            # let them land, behind a few kernels that lie outside the stretch
            torch.cuda.synchronize()
            time.sleep(SETTLE_S)
            pad = torch.zeros(1, device="cuda")
            for _ in range(PAD_KERNELS):
                pad.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(SETTLE_S)
        self.prof.stop()

    def summarize(self) -> dict:
        """Read the stopped profile's trace once and reduce it."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return summarize(events, self.h0, self.h1, self.spans)


def summarize(events, h0: float, h1: float, spans) -> dict:
    """The reduction of a Chrome trace's events (microseconds) over the
    stretch between the two marker kernels; `spans` [(name, start, end,
    on the main thread)] on the host clock, h0 / h1 the host times at
    which the markers were launched. The profiler can drop the records
    of kernels that run near its start or stop; one marker, told by its
    length, still ties the two clocks. A trace of kernels with neither
    is refused."""
    marks = sorted((e for e in events if e.get("cat") == "kernel"
                    and MARKER in e.get("name", "")), key=lambda e: e["ts"])
    start = [e for e in marks if e["dur"] < END_MARK_US]
    end = [e for e in marks if e["dur"] >= END_MARK_US]
    if start:
        t0 = start[0]["ts"]
        off = t0 - h0 * 1e6
        t1 = end[-1]["ts"] + end[-1]["dur"] if end else h1 * 1e6 + off
    elif end:
        t1 = end[-1]["ts"] + end[-1]["dur"]
        off = end[-1]["ts"] - h1 * 1e6
        t0 = h0 * 1e6 + off
    elif not any(e.get("cat") == "kernel" for e in events):
        t0, t1, off = h0 * 1e6, h1 * 1e6, 0.0      # no card: no device events to read
    else:
        raise RuntimeError("the trace holds neither marker kernel: its device clock "
                           "cannot be tied to the host's")
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
           and MARKER not in e.get("name", "")
           and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    by_name = defaultdict(float)
    by_class = defaultdict(float)
    for e in dev:
        d = (min(e["ts"] + e["dur"], t1) - max(e["ts"], t0)) * 1e-6
        by_name[e["name"]] += d
        by_class[kernel_class(e["name"])] += d
    busy = union((max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    main = sorted((a * 1e6 + off, b * 1e6 + off, name) for name, a, b, m in spans if m)
    label = _labeller(main)
    gap_by = defaultdict(float)
    for a, b in gaps:
        gap_by[label((a + b) / 2)] += (b - a) * 1e-6
    return {"window_s": (t1 - t0) * 1e-6, "busy_s": busy_s,
            "device_by_name": dict(by_name),
            "device_by_class": dict(by_class), "idle_by_host": dict(gap_by)}


def _labeller(spans):
    """t -> what the main thread was doing: the benchmark's span around it,
    else "after" the last span that ended before it."""
    starts = [a for a, _, _ in spans]
    ends = sorted((b, name) for _, b, name in spans)
    end_ts = [b for b, _ in ends]

    def label(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            return spans[i][2]
        j = bisect.bisect_right(end_ts, t) - 1
        return f"after {ends[j][1]}" if j >= 0 else "before any span"

    return label


def breakdown(summary: dict) -> dict:
    """The ten device operations that took most time and the ten host
    activities under which the device idled longest, in seconds."""
    ops = defaultdict(float)
    for name, d in summary["device_by_name"].items():
        ops[short_name(name)] += d
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["idle_by_host"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
