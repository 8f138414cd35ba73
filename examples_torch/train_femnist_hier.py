"""Multi-PON hierarchical FL on the port: FEMNIST over a forest of PON
trees feeding a metro tier, k-step ``hier_sfl`` aggregation vs the flat
baselines. Per-PON selection is held constant, so the population — and the
involved clients per round — grow with ``--n-pons`` while every segment's
upstream Mbits stay flat. The counterpart of
``examples/train_femnist_hier.py``, driven through
``repro_torch.launch.femnist.run`` on the card, or on the CPU with
``--device cpu``.

    python examples_torch/train_femnist_hier.py --rounds 8 --n-pons 4
    python examples_torch/train_femnist_hier.py --rounds 8 \\
        --n-pons 8 --server-opt yogi      # composes the FedOpt server step
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None) -> list:
    """Print the reference's CSV and final line; return the rows as dicts
    (``round``, ``<mode>_acc``, ``<mode>_involved`` for each mode)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--per-pon-selected", type=int, default=8,
                    help="clients selected per PON per round (total N = "
                         "this × --n-pons)")
    ap.add_argument("--full", action="store_true",
                    help="exact LEAF CNN (26.4 MB updates); default reduced")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    from repro_torch import fl, obs
    from repro_torch.launch import femnist
    fl.add_experiment_cli_args(ap, strategy_default="hier_sfl")
    args = ap.parse_args(argv)

    n_selected = args.per_pon_selected * max(1, args.n_pons)
    sess = obs.session_from_args(args, driver="round_loop")
    try:
        res = femnist.run_from_args(args, n_selected)
    finally:
        sess.finish()      # merged metrics / trace / incidents across modes
    rows = femnist.print_rows(res)
    finals = " | ".join(f"{m} {r['accs'][-1]:.3f}" for m, r in res.items())
    print(f"\nfinal accuracy ({args.n_pons} PONs, N={n_selected}): {finals}")
    return rows


if __name__ == "__main__":
    main()
