"""The paper's experiment (Fig. 2) on the port: FedAvg on FEMNIST over a
simulated PON, classical benchmark vs two-step SFL — accuracy and
involvement per round. The counterpart of ``examples/train_femnist_sfl.py``:
the same flags (the shared ``fl`` flag set: any registered strategy can
stand in for SFL, the fault-tolerance knobs ``--overselect``,
``--p-crash``, ``--p-transient`` flow through the loop's mask path, and
``--compress`` compresses the uplink), driven through
``repro_torch.launch.femnist.run`` on the card, or on the CPU with
``--device cpu``.

    python examples_torch/train_femnist_sfl.py --rounds 30
    python examples_torch/train_femnist_sfl.py --rounds 200 --full \\
        --n-selected 128        # the paper's full setting
    python examples_torch/train_femnist_sfl.py --rounds 30 \\
        --strategy fedopt --server-opt yogi     # FedYogi server optimizer
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None) -> list:
    """Print the reference's CSV and final line; return the rows as dicts
    (``round``, ``<mode>_acc``, ``<mode>_involved`` for each mode)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--n-selected", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="exact LEAF CNN (26.4 MB updates); default reduced")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # strategy + event-simulator transport + fault-tolerance knobs — the
    # shared flag set (defaults = the paper's fixed slice, SFL)
    from repro_torch import fl
    from repro_torch.launch import femnist
    fl.add_experiment_cli_args(ap)
    args = ap.parse_args(argv)

    res = femnist.run_from_args(args, args.n_selected)
    rows = femnist.print_rows(res)
    finals = " | ".join(f"{m} {r['accs'][-1]:.3f}" for m, r in res.items())
    print(f"\nfinal accuracy: {finals} (paper: 0.77 vs 0.85 at N=128)")
    return rows


if __name__ == "__main__":
    main()
