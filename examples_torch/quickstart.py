"""Quickstart on the port: one SFL federated round, end to end.

Shows the whole pipeline: synthetic FEMNIST -> client selection -> PON
timing (who beats the 25 s deadline) -> local SGD on each involved client
-> the paper's two-step aggregation (ONU θ then CPS) -> global update,
with the upstream-traffic accounting that is the paper's headline. The
counterpart of ``examples/quickstart.py``; it runs on the card, or on the
CPU with ``--device cpu``.

    python examples_torch/quickstart.py
    python examples_torch/quickstart.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs, device as device_mod  # noqa: E402
from repro_torch.core import fedavg, selection  # noqa: E402
from repro_torch.core.fedavg import FLConfig  # noqa: E402
from repro_torch.data import femnist  # noqa: E402
from repro_torch.models import femnist_cnn  # noqa: E402
from repro_torch.pon import PonConfig, round_times  # noqa: E402


def main(argv=None) -> dict:
    """Print the classical and SFL lines and the trained line; return them
    as ``{mode: {"selected", "involved", "upstream_mbits"}}`` with the SFL
    entry's ``acc``, ``eval_loss``, ``uplink_models`` and the trained
    ``params``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    cfg = configs.get("femnist_cnn").reduced()     # the reference's reduced CNN
    fl = FLConfig(n_selected=48, local_steps=8)
    pon = PonConfig()
    rng = np.random.default_rng(0)

    clients, eval_set = femnist.generate(femnist.FemnistConfig(n_clients=fl.n_clients))
    counts = femnist.sample_counts(clients)
    onu = fedavg.onu_of_client(fl)
    params = femnist_cnn.init_params(cfg, torch.Generator().manual_seed(0), dev)
    eval_batch = {k: torch.from_numpy(v).to(dev) for k, v in eval_set.items()}

    out = {}
    for mode in ("classical", "sfl"):
        sel = selection.select_clients(rng, fl.n_clients, fl.n_selected)
        rt = round_times(pon, rng, sel, onu, counts, mode)
        active = sel[rt["involved"] > 0]
        print(f"[{mode:9s}] selected {len(sel)}, involved {len(active)}, "
              f"upstream {rt['upstream_mbits']:.0f} Mb "
              f"({rt['upstream_mbits']/8:.1f} MB)")
        out[mode] = {"selected": len(sel), "involved": len(active),
                     "upstream_mbits": float(rt["upstream_mbits"])}
        if mode == "sfl":
            batches = [femnist.client_minibatches(rng, clients[c], fl.local_steps,
                                                  fl.local_batch) for c in active]
            cb = {k: torch.from_numpy(np.stack([b[k] for b in batches])).to(dev)
                  for k in batches[0]}
            deltas, _ = fedavg.train_selected_clients(params, cb, femnist_cnn.loss_fn, fl)
            params, stats = fedavg.apply_round(
                params, deltas, counts[active], np.ones(len(active), np.float32),
                onu[active], fl.n_onus, mode)
            m = fedavg.evaluate(params, eval_batch, femnist_cnn.loss_fn)
            out[mode].update(acc=float(m["eval_acc"]), eval_loss=float(m["eval_loss"]),
                             uplink_models=int(stats["uplink_models"]), params=params)
            print(f"            trained: eval acc {out[mode]['acc']:.3f}, "
                  f"θ uploads = {out[mode]['uplink_models']} "
                  f"(constant, vs {len(active)} models classically)")
    return out


if __name__ == "__main__":
    main()
