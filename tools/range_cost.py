"""What the FL round's training ranges cost on the host: one vmap'd chunk of
local training as the benchmark's cells run it (the FEMNIST CNN at full
width, 16 clients, H = 8 SGD steps of batch 10), timed with the ranges the
program opens (``fl.grad``, ``fl.forward``, ``fl.sgd``: 24 a chunk) and
with ``obs.profile.named_scope`` made a null context, in turns, under no
profiler, under one recording the card alone (the benchmark's measured
window) and under one recording the host too (its traced window):

    python3 tools/range_cost.py [--reps 20]

Prints the card's name and power limit, then per profiler the median ms
of a chunk with and without the ranges and their difference; a round is 8
chunks in ``fl_sfl_n128`` and 32 in ``fl_hier_int8_n512``. Needs one card.
"""
import argparse
import contextlib
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core.fedavg import FLConfig, train_selected_clients  # noqa: E402
from repro_torch.models import femnist_cnn  # noqa: E402
from repro_torch.obs import profile as obs_profile  # noqa: E402

PROFILERS = {
    "none": contextlib.nullcontext,
    "card": lambda: profile(activities=[ProfilerActivity.CUDA]),
    "host+card": lambda: profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    print("card:", subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    params = femnist_cnn.init_params(configs.get("femnist_cnn"), torch.Generator().manual_seed(0),
                                     dev)
    fl = FLConfig(local_steps=8, local_batch=10, client_chunk=16, local_lr=0.01)
    g = torch.Generator().manual_seed(1)
    batches = {"images": torch.rand(16, 8, 10, 28, 28, 1, generator=g).to(dev),
               "labels": torch.randint(0, 62, (16, 8, 10), generator=g,
                                       dtype=torch.int32).to(dev)}
    ranged = obs_profile.named_scope

    def chunk(scope) -> float:
        obs_profile.named_scope = scope
        torch.cuda.synchronize()
        t = time.perf_counter()
        train_selected_clients(params, batches, femnist_cnn.loss_fn, fl)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    try:
        for _ in range(3):
            chunk(ranged)
        for name, make in PROFILERS.items():
            ms = {"ranges": [], "none": []}
            with make():
                for r in range(args.reps):
                    for which in (("ranges", "none") if r % 2 else ("none", "ranges")):
                        scope = ranged if which == "ranges" else (lambda _: obs_profile._NO_RANGE)
                        ms[which].append(1e3 * chunk(scope))
            on, off = statistics.median(ms["ranges"]), statistics.median(ms["none"])
            print(f"profiler {name}: a chunk {on:.3f} ms with the ranges, {off:.3f} without, "
                  f"{on - off:+.3f} ms ({100 * (on - off) / off:+.2f}%); with "
                  + " ".join(f"{x:.2f}" for x in ms["ranges"]) + "; without "
                  + " ".join(f"{x:.2f}" for x in ms["none"]), flush=True)
    finally:
        obs_profile.named_scope = ranged
    return 0


if __name__ == "__main__":
    sys.exit(main())
