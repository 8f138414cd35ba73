"""Asynchronous FEMNIST over the simulated PON — the event-driven runtime
on the port (the counterpart of ``examples/train_femnist_async.py``).

Runs the paper's FEMNIST/CNN experiment through ``runtime.Orchestrator``
instead of lockstep rounds: client dispatches (one client's H local steps
on the card), the wireless leg, ONU θ gathering and DBA grants are all
events on a simulated wall clock, and the aggregation policy decides when
the server folds arrivals in (``--policy sync|semi_sync|fedbuff``). The
trajectory is reported against simulated seconds.

    PYTHONPATH=src python -m repro_torch.launch.femnist_async --full --rounds 8
    PYTHONPATH=src python -m repro_torch.launch.femnist_async --rounds 3 --n-selected 16 \\
        --onus 4 --clients-per-onu 5 --policy semi_sync --device cpu
    PYTHONPATH=src python -m repro_torch.launch.femnist_async --full --policy fedbuff \\
        --buffer-k 8 --strategy fedopt --server-opt yogi

The flags are the reference's shared set (``fl.add_experiment_cli_args``:
the PON transport, strategy, failure, compression and runtime knobs);
``--full`` selects the paper's CNN (26.4 MB updates; default reduced), and
without ``--device cpu`` it runs on the card and raises if there is none.
"""
from __future__ import annotations

import argparse
from typing import Dict, Iterable, Optional, Tuple

import torch

from repro_torch import configs, device as device_mod, fl
from repro_torch.data import femnist
from repro_torch.models import femnist_cnn


def run(exp: fl.ExperimentConfig, *, full: bool = False, n_updates: Optional[int] = None,
        until_s: Optional[float] = None, params: Optional[Dict[str, torch.Tensor]] = None,
        device: str | torch.device = "cuda", data: Optional[Tuple[list, dict]] = None,
        callbacks: Iterable = (), eval_every: int = 1):
    """Run ``exp`` (its FLConfig, strategy and policy) through the
    Orchestrator on a ``ClientStackedBackend`` until ``n_updates`` server
    updates (default ``exp.n_rounds``) or ``until_s`` simulated seconds.

    Returns ``(history, orchestrator)``; the orchestrator holds the backend
    (``orch.backend.params``), the clock and the run's Mbits totals.
    ``params`` (port layout, e.g. bridged from the reference's init)
    replaces the seeded init; ``data`` (``femnist.generate``'s clients and
    eval set for this population and seed) skips generating them again.
    """
    from repro_torch import runtime

    dev = device_mod.resolve(device)
    flc = exp.fl
    cfg = configs.get("femnist_cnn") if full else configs.get("femnist_cnn").reduced()
    clients, eval_set = data if data is not None else femnist.generate(
        femnist.FemnistConfig(n_clients=flc.n_clients, seed=exp.seed + 7))
    if len(clients) != flc.n_clients:
        raise ValueError(f"data holds {len(clients)} clients, the population "
                         f"is {flc.n_clients}")
    p0 = (femnist_cnn.init_params(cfg, torch.Generator().manual_seed(exp.seed), dev)
          if params is None else {k: v.to(dev) for k, v in params.items()})
    backend = fl.ClientStackedBackend(
        flc, exp.make_strategy(), p0, clients,
        {k: torch.from_numpy(v).to(dev) for k, v in eval_set.items()},
        femnist_cnn.loss_fn, sample_counts=femnist.sample_counts(clients),
        eval_every=eval_every)
    orch = runtime.Orchestrator(exp, backend, callbacks=callbacks)
    return orch.run(n_updates, until_s=until_s), orch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=8,
                    help="simulated budget in deadline-windows (25 s each)")
    ap.add_argument("--n-selected", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="exact LEAF CNN (26.4 MB updates); default reduced")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    fl.add_experiment_cli_args(ap)
    ap.set_defaults(policy="fedbuff")
    args = ap.parse_args(argv)
    fl.refuse_unported_flags(ap, args)

    exp = fl.experiment_config_from_args(args, n_rounds=args.rounds)
    exp = exp.with_fl(n_selected=args.n_selected, local_steps=8, local_lr=0.06)
    pon = exp.fl.pon_config()
    budget_s = args.rounds * pon.sync_threshold_s

    def on_update(orch, rec):
        print(f"t={rec['t_s']:7.1f}s update {rec['round']:3} "
              f"acc {rec.get('acc', 0.0):.3f} "
              f"involved {rec['involved']:.0f} "
              f"staleness {rec.get('staleness_mean', 0.0):.2f} "
              f"upstream {rec['upstream_mbits']:.0f} Mb "
              f"wall {rec['wall_s']:.2f}s")

    print(f"policy={exp.policy} strategy={exp.strategy} "
          f"budget={budget_s:.0f} sim-s (dba={pon.dba}, "
          f"bg_load={pon.background_load})")
    hist, _ = run(exp, full=args.full, n_updates=10_000, until_s=budget_s,
                  device=args.device, callbacks=[on_update])
    accs = [r.get("acc", 0.0) for r in hist]
    # "version" counts actual server-model updates; a zero-arrival window
    # emits a History row without moving the model
    n_upd = int(hist.last().get("version", 0)) if len(hist) else 0
    print(f"\n{n_upd} server updates in {budget_s:.0f} simulated seconds; "
          f"final accuracy {accs[-1] if accs else 0.0:.3f}")


if __name__ == "__main__":
    main()
