"""The benchmark of the PyTorch/CUDA port (``repro_torch``), one cell a run:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout, on a machine with the NVIDIA cards the
cell asks for. It builds the cell from its files, makes its inputs from the
seed, warms up the cell's own shapes, measures for ``--seconds`` seconds,
compares what the timed path produced with the plain reference, and prints
one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and with ``--trace 1`` the traced window's ``breakdown``),
then ``checks``, each compared number beside its limit.

Without a card, or with fewer than the cell asks for, it exits 1 and
prints no result; it exits 3 if the JAX package or JAX was loaded. The
port's kernels build into ``build/repro_torch/`` inside the checkout, and
any other compiler cache goes to fixed directories under ``build/``, so a
checkout's first run alone compiles.
"""
import time

T0 = time.perf_counter()   # set-up is timed from the process's start

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from portbench.harness import cells, runner

    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 1
    out = cells.driver(cell.workload["driver"]).run(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    bad = runner.foreign_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; the port must not", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips}
    runner.emit(runner.result(cell, out, bool(args.trace), device), out.checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
