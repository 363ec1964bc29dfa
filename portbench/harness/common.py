"""What every run shares: the manifest, the device check, the published
peaks and the roofline bound, the per-layer metric readers, the
correctness report, the import check and the result line."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent          # portbench/
ROOT = HERE.parent                                      # the checkout

# published dense peaks of one H100 SXM (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# top-level module names that must not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "speinet_tpu")


def process_start() -> float:
    """Wall-clock time at which this process started (Linux /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


_T0 = [time.time()]


def phase(name: str) -> None:
    """Note on standard error the seconds since the previous phase."""
    now = time.time()
    print(f"phase {name}: {now - _T0[0]:.2f} s", file=sys.stderr, flush=True)
    _T0[0] = now


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the bf16 peak and the bytes over the memory rate."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: `speinet_tpu_torch` is not `speinet_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Manifest:
    """BENCHMARK.json with the cell's configuration and traffic files."""

    def __init__(self, root: Path = ROOT):
        self.data = json.loads((root / "BENCHMARK.json").read_text())
        self.root = root

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((HERE / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        """The cell's limit for each number the check compares."""
        return json.loads((HERE / "limits" / f"{cell}.json").read_text())["limits"]

    @staticmethod
    def _applies(metric: dict, cell: str) -> bool:
        """A metric is the cell's where its `workloads` name the cell, or
        where it has none."""
        return cell in metric.get("workloads", [cell])

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.data["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.data["per_layer"] if self._applies(m, cell)]


def load_reader(name: str):
    """The reader module of per-layer metric `name`: metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_per_layer(manifest: Manifest, cell: str, ctx: dict) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in manifest.per_layer(cell):
        value = load_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


class Checks:
    """The numbers compared for `correct`, each beside its limit (a number
    passes when it is at most its limit)."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.values: dict = {}

    def add(self, name: str, value: float) -> None:
        self.values[name] = float(value)

    def correct(self) -> bool:
        """Every number with a limit read, none NaN, each within its limit."""
        return bool(self.limits) and all(
            k in self.values and self.values[k] == self.values[k]
            and self.values[k] <= self.limits[k] for k in self.limits)

    def table(self) -> dict:
        return {k: {"value": self.values.get(k), "limit": self.limits[k]}
                for k in self.limits}

    def readings(self) -> dict:
        """The numbers read that have no limit (shown, not compared)."""
        return {k: v for k, v in self.values.items() if k not in self.limits}


def device_info(device, peak_bytes: int, summary: dict | None = None) -> dict:
    """The result's device record (one card), with the profiled stretch's
    busy and window seconds from a trace summary."""
    import torch

    out = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak_bytes)}
    if summary is not None:
        out.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    return out


def finish(result: dict, checks: Checks) -> int:
    """Print the comparison's numbers on standard error, refuse the result
    if a forbidden module was loaded, else print the result line last."""
    table = checks.table()
    for k, v in checks.readings().items():
        print(f"reading {k}: {v!r} (not compared)", file=sys.stderr)
    for k, v in table.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in this process: {bad}", file=sys.stderr)
        return 3
    result["correct"] = checks.correct()
    result["checks"] = table
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
