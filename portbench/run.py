"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from BENCHMARK.json at the checkout's root, its
configuration from portbench/configs/ and its traffic from
portbench/traffic/; the traffic names the run loop (`portbench/harness/
<generator>.py`) that drives the program. Prints the comparison's numbers
on standard error and, as the last line of standard output, one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones and a breakdown) and device. Exits
non-zero without a result where CUDA or the cell's cards are missing, or
where JAX or the JAX package was loaded."""

from __future__ import annotations

import argparse
import importlib
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from portbench.harness.common import process_start  # noqa: E402

T_PROCESS = process_start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")

    import torch

    from portbench.harness.common import Checks, Manifest, finish, read_per_layer

    manifest = Manifest()
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cfg = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    checks = Checks(manifest.limits(args.workload))
    loop = importlib.import_module(f"portbench.harness.{traffic['generator']}")
    out = loop.run(cfg, traffic, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_PROCESS, checks)
    if args.trace:
        metrics = read_per_layer(manifest, args.workload, out["per_layer_ctx"])
    else:
        units = {m["name"]: m["unit"] for m in manifest.end_to_end(args.workload)}
        metrics = {k: {"value": out["e2e"][k], "unit": u} for k, u in units.items()}
    result = {"correct": None, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": out["device"]}
    if args.trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    return finish(result, checks)


if __name__ == "__main__":
    sys.exit(main())
