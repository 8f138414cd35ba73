"""The paper's experiment (Fig. 2) on the port: FedAvg on FEMNIST over the
simulated PON, classical benchmark vs two-step SFL — accuracy and
involvement per round. Mirrors ``benchmarks/bench_accuracy.run`` and the
columns of ``examples/train_femnist_sfl.py`` (``--per-pon-selected`` as
``examples/train_femnist_hier.py``).

    PYTHONPATH=src python -m repro_torch.launch.femnist --full --rounds 3
    PYTHONPATH=src python -m repro_torch.launch.femnist --rounds 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.femnist --full --compress int8
    PYTHONPATH=src python -m repro_torch.launch.femnist --rounds 2 --device cpu \
        --dba fl_priority --wavelengths 2 --bg-load 0.3
    PYTHONPATH=src python -m repro_torch.launch.femnist --rounds 2 --device cpu \
        --strategy hier_sfl --n-pons 2

The PON flags are the reference's (``pon.add_pon_cli_args``: the DBA
policy, TWDM wavelengths, background load, the metro forest and the
simulator engine). ``--strategy`` (sfl_two_step, classical, fedprox,
fedopt, hier_sfl) is compared against classical, with ``--fedprox-mu``,
``--server-opt`` and ``--server-lr``. ``--compress {none,int8,int4,topk}``
(with ``--topk-frac`` and ``--error-feedback``) compresses what crosses
every upstream tier: each ONU's θ (and under hier_sfl each OLT's Φ and the
metro node's Ψ), each involved client's δ under classical. The
observability flags are the reference's (``obs.add_obs_cli_args``:
``--trace-out``, ``--metrics-out``, ``--report-out``, ``--health``,
``--incidents-out``, ``--slo-*``): the trace and metrics cover every
compared strategy, the run bundle the last one's config and History.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import configs, device as device_mod, fl, obs
from repro_torch.core.fedavg import FLConfig
from repro_torch.data import femnist
from repro_torch.models import femnist_cnn
from repro_torch.pon import PonConfig, add_pon_cli_args, pon_config_from_args


def run(n_rounds: int = 30, n_selected: int = 128, full: bool = False,
        seed: int = 0, modes: Sequence[str] = ("classical", "sfl"),
        pon: Optional[PonConfig] = None, overselect: float = 0.0,
        params: Optional[Dict[str, torch.Tensor]] = None,
        device: str | torch.device = "cuda", local_steps: int = 8,
        compress: str = "none", topk_frac: float = 0.01,
        error_feedback: bool = False, strategy_kwargs: Optional[dict] = None,
        data: Optional[Tuple[list, dict]] = None):
    """Run each strategy in ``modes`` through the RoundLoop.

    Returns ``{mode: {"accs": [...], "involved": [...], "loop": RoundLoop}}``;
    the loop holds the History, the final parameters
    (``loop.backend.params``) and the RNG stream. ``pon`` gives the
    transport and the topology (``n_onus``, ``clients_per_onu``,
    ``n_pons``). ``params`` (port layout, e.g. bridged from the reference's
    init) replaces the seeded init; ``local_steps`` is H, the paper's 8 by
    default. ``strategy_kwargs`` (``fl.strategy_kwargs_from_args``' dict)
    are filtered per mode, so the classical baseline takes none of another
    strategy's knobs; ``compress``, ``topk_frac`` and ``error_feedback`` set
    every strategy's wire compression. ``data`` (``femnist.generate``'s
    clients and eval set, for this population and seed) skips generating
    them again.
    """
    dev = device_mod.resolve(device)
    cfg = configs.get("femnist_cnn") if full else configs.get("femnist_cnn").reduced()
    topo = {} if pon is None else {"n_onus": pon.n_onus,
                                   "clients_per_onu": pon.clients_per_onu,
                                   "n_pons": pon.n_pons}
    flc = FLConfig(n_selected=n_selected, local_steps=local_steps, local_lr=0.06,
                   pon=pon, **topo)
    clients, eval_set = data if data is not None else femnist.generate(
        femnist.FemnistConfig(n_clients=flc.n_clients, seed=seed + 7))
    if len(clients) != flc.n_clients:
        raise ValueError(f"data holds {len(clients)} clients, the population "
                         f"is {flc.n_clients}")
    eval_batch = {k: torch.from_numpy(v).to(dev) for k, v in eval_set.items()}
    counts = femnist.sample_counts(clients)
    wire = dict(compress=compress, topk_frac=topk_frac, error_feedback=error_feedback)

    results = {}
    for mode in modes:
        p0 = (femnist_cnn.init_params(cfg, torch.Generator().manual_seed(seed), dev)
              if params is None else {k: v.to(dev) for k, v in params.items()})
        skw = fl.filter_strategy_kwargs(mode, dict(strategy_kwargs or {}, **wire))
        strategy = fl.make_strategy(mode, **skw)
        backend = fl.ClientStackedBackend(flc, strategy, p0,
                                          clients, eval_batch,
                                          femnist_cnn.loss_fn,
                                          sample_counts=counts)
        exp = fl.ExperimentConfig(fl=flc, strategy=fl.canonical_name(mode),
                                  strategy_kwargs=tuple(sorted(skw.items())),
                                  overselect=overselect, n_rounds=n_rounds, seed=seed)
        loop = fl.RoundLoop(exp, backend)
        hist = loop.run()
        results[mode] = {"accs": [a if a is not None else 0.0
                                  for a in hist.column("acc")],
                         "involved": hist.column("involved"),
                         "loop": loop}
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--n-selected", type=int, default=128)
    ap.add_argument("--per-pon-selected", type=int, default=None,
                    help="clients selected per PON per round (total N = this "
                         "× --n-pons); overrides --n-selected")
    ap.add_argument("--full", action="store_true",
                    help="exact LEAF CNN (26.4 MB updates); default reduced")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--strategy", default="sfl_two_step",
                    help=f"{'|'.join(fl.strategy_names())} (aliases: sfl, hier); "
                         "compared against classical")
    add_pon_cli_args(ap)
    fl.add_strategy_cli_args(ap)
    ap.add_argument("--compress", default="none",
                    choices=["none", "int8", "int4", "topk"],
                    help="wire compression for every transport tier "
                         "(θ/Φ/Ψ or client uploads): stochastic-rounding "
                         "int8/int4 or magnitude top-k (DESIGN.md §17)")
    ap.add_argument("--topk-frac", type=float, default=0.01,
                    help="top-k: fraction of elements kept per leaf "
                         "(wire bills value+index per kept element)")
    ap.add_argument("--error-feedback", action="store_true",
                    help="carry the compression residual into the next "
                         "round (EF-SGD; per-tier for sfl/hier, per-client "
                         "for classical)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    obs.add_obs_cli_args(ap)
    args = ap.parse_args(argv)

    modes = fl.comparison_modes(args.strategy)
    n_selected = (args.n_selected if args.per_pon_selected is None
                  else args.per_pon_selected * max(1, args.n_pons))
    sess = obs.session_from_args(args, driver="round_loop")
    res = {}
    try:
        res = run(n_rounds=args.rounds, n_selected=n_selected, full=args.full,
                  seed=args.seed, modes=modes, pon=pon_config_from_args(args),
                  device=args.device, compress=args.compress,
                  topk_frac=args.topk_frac, error_feedback=args.error_feedback,
                  strategy_kwargs=fl.strategy_kwargs_from_args(args))
    finally:
        # the artifacts (of what ran, should run raise), then the ambient
        # context restored; the bundle holds the last strategy's run
        last = res[modes[-1]]["loop"] if res else None
        sess.finish(cfg=last.cfg if last else None,
                    history=last.history if last else None)
    print("round," + ",".join(f"{m}_acc" for m in modes)
          + "," + ",".join(f"{m}_involved" for m in modes))
    for i in range(args.rounds):
        print(f"{i},"
              + ",".join(f"{res[m]['accs'][i]:.4f}" for m in modes) + ","
              + ",".join(f"{res[m]['involved'][i]:.0f}" for m in modes))
    if args.compress != "none":
        wire = res[modes[0]]["loop"].history.column("wire_mbits")[0]
        print(f"# wire: {args.compress} payload {wire} Mb per model "
              f"(f32 {PonConfig().model_mbits} Mb)")
    finals = " | ".join(f"{m} {res[m]['accs'][-1]:.3f}" for m in modes)
    print(f"\nfinal accuracy ({args.n_pons} PON(s), N={n_selected}): {finals} "
          "(paper: 0.77 vs 0.85 at N=128)")


if __name__ == "__main__":
    main()
