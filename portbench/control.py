"""Readings that the correctness limits are set from, on the chip at the
cell's own size:

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--program]

For each seed the plain reference is replayed soundly and then put in the
program's place as the control (computed in the nearest precision below
the configuration's) and with each planted fault the cell can have (half
of the batch left out, the mean over the rest; an answer altered where it
is made); each is compared with the sound replay by every number that
applies to the cell. A state left unchanged reads 1 on the change and
update norms by their definition and needs no run. With ``--program`` it
reads the program's sound runs instead: each seed's set-up, its compared
rounds and one round of window, in this one process. One JSON line a
seed and variant. The benchmark's runs never run this.
"""
import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true",
                    help="read the program's sound runs, not the control's")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench.harness import cells

    cell = cells.load(args.workload)
    driver = cells.driver(cell.workload["driver"])
    if args.program:    # every number, the cell's limits beside those it has
        lim = cell.workload["limits"]
        cell.workload["limits"] = {n: lim.get(n, math.inf) for n in driver.NUMBERS}
    dev = torch.device("cuda")
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 1
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.program:
            found = {"program": driver.run(cell, seed, 0.0, False, "cuda", t0).checks}
            gc.collect()
            torch.cuda.empty_cache()
        else:
            found = driver.readings(cell, seed, dev)
        for variant, checks in found.items():
            print(json.dumps({"workload": cell.name, "seed": seed, "variant": variant,
                              "readings": {n: v for n, v, _ in checks},
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
