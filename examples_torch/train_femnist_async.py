"""Asynchronous FEMNIST over the simulated PON on the port — the
event-driven runtime. The counterpart of
``examples/train_femnist_async.py``.

Runs the paper's FEMNIST/CNN experiment through
``repro_torch.runtime.Orchestrator`` instead of lockstep rounds: client
dispatches, the wireless leg, ONU θ gathering and DBA grants are all
events on a simulated wall clock, and the aggregation policy decides when
the server folds arrivals in (``--policy sync|semi_sync|fedbuff``). The
trajectory is reported against simulated seconds, the axis the policies
differ on. Local training runs on the card, or on the CPU with
``--device cpu``.

    python examples_torch/train_femnist_async.py --rounds 8
    python examples_torch/train_femnist_async.py --rounds 8 \\
        --policy semi_sync --bg-load 0.8 --dba fl_priority
    python examples_torch/train_femnist_async.py --rounds 8 \\
        --policy fedbuff --buffer-k 8 --strategy fedopt --server-opt yogi
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None) -> list:
    """Print the reference's update lines and closing line; return the
    History rows (one a server update or window)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=8,
                    help="simulated budget in deadline-windows (25 s each)")
    ap.add_argument("--n-selected", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    from repro_torch import fl
    fl.add_experiment_cli_args(ap)
    ap.set_defaults(policy="fedbuff")
    args = ap.parse_args(argv)

    from repro_torch import obs
    from repro_torch.launch import femnist_async

    exp = fl.experiment_config_from_args(args, n_rounds=args.rounds)
    exp = exp.with_fl(n_selected=args.n_selected, local_steps=8, local_lr=0.06)
    pon = exp.fl.pon_config()
    budget_s = args.rounds * pon.sync_threshold_s

    def on_update(orch, rec):
        print(f"t={rec['t_s']:7.1f}s update {rec['round']:3} "
              f"acc {rec.get('acc', 0.0):.3f} "
              f"involved {rec['involved']:.0f} "
              f"staleness {rec.get('staleness_mean', 0.0):.2f} "
              f"upstream {rec['upstream_mbits']:.0f} Mb")

    print(f"policy={exp.policy} strategy={exp.strategy} "
          f"budget={budget_s:.0f} sim-s (dba={pon.dba}, "
          f"bg_load={pon.background_load})")
    sess = obs.session_from_args(args, driver="orchestrator")
    hist = None
    try:
        # the reduced CNN, data of seed + 7 and the init of the seed, as the
        # reference builds them
        hist, _ = femnist_async.run(exp, n_updates=10_000, until_s=budget_s,
                                    device=args.device, callbacks=[on_update])
    finally:
        sess.finish(cfg=exp, history=hist)    # --report-out/--trace-out etc.
    accs = [r.get("acc", 0.0) for r in hist]
    # "version" counts actual server-model updates; a zero-arrival window
    # emits a History row without moving the model
    n_upd = int(hist.last().get("version", 0)) if len(hist) else 0
    print(f"\n{n_upd} server updates in {budget_s:.0f} simulated seconds; "
          f"final accuracy {accs[-1] if accs else 0.0:.3f}")
    return list(hist)


if __name__ == "__main__":
    main()
