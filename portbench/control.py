"""Read the check's control and faults on the card at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3

Prints one JSON line per seed: the numbers the cell's check compares, as
the control (the float8 reference in the program's place) and each
planted fault read them. The benchmark's own runs do not run this."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import controls
    from portbench.harness.common import Manifest

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    m = Manifest()
    cell = m.cell(args.workload)
    cfg, traffic = m.config(cell["config"]), m.traffic(cell["traffic"])
    read = controls.video_readings if traffic["generator"] == "video" else \
        controls.train_readings
    for seed in args.seeds:
        r = read(cfg, traffic, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
