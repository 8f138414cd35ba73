"""The LM gradient regime — the counterpart of ``repro/launch/train.py
--driver loop``: one train step per federated round through the port's
RoundLoop and ``GradientBackend``, on one card or data parallel over the
ranks of a ``torch.distributed`` world.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --smoke \\
        --steps 3 --batch 4 --seq 32 --device cpu --ckpt /tmp/ck
    python -m repro_torch.launch.train --arch olmo-1b --steps 20 --batch 8 --seq 2048
    PYTHONPATH=src torchrun --nproc_per_node 2 -m repro_torch.launch.train --smoke \\
        --steps 3 --batch 4 --seq 32 --device cpu

Each round selects ``--batch`` clients (one per batch row, with
``--overselect`` backups), runs the PON transport (the reference's flags:
``--dba``, ``--wavelengths``, ``--bg-load``, ``--n-pons`` and the rest of
``pon.add_pon_cli_args``) and the synthetic failures, folds k_ij · mask
into the rows' ``client_weight``
and takes one optimizer step on the card; ``--ckpt`` saves every
``--ckpt-every`` steps and at the end, and a run resumes from the latest
step, replaying the skipped rounds' draws, so a resumed run equals an
uninterrupted one. Without ``--device cpu`` it runs on the card and raises
if there is none. Under an initialized process group (``torchrun``
starts one: gloo on the CPU, NCCL on cards) the mesh is (world, 1)
("data", "model"), as the reference's, and the strategy's transport picks
the gradients' schedule (:func:`build_rules`); rank 0 alone prints and
checkpoints. ``--strategy`` takes any registered strategy (``hier_sfl``
with ``--n-pons`` bills the metro forest's k-step transport) with
``--fedprox-mu``, ``--server-opt`` and ``--server-lr`` as the reference's.
``--compress`` scales the wire the PON transport bills, as in the
reference's gradient regime. Flags of machinery the port does not have yet
are refused, naming the ROADMAP.md item that brings it.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, device as device_mod, fl
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.common.sharding import ShardingRules
from repro_torch.core.compression import SCHEMES
from repro_torch.core.fedavg import FLConfig
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.pon import PonConfig, add_pon_cli_args, pon_config_from_args

# reference flags the port refuses, with the ROADMAP.md item that ports their machinery
_REFUSED = {"trace_out": "Queue 1 item 5 (repro.obs)",
            "metrics_out": "Queue 1 item 5 (repro.obs)"}


def build_rules(mesh, transport: str) -> ShardingRules:
    """Sharding rules induced by the strategy's transport: ``classical``
    replicates params (flat all-reduce benchmark); ``sfl`` takes the FSDP
    schedule (the in-network aggregation tiers map to the reduce-scatter /
    all-reduce stages of the same collective)."""
    axes = tuple(mesh.mesh_dim_names)
    batch = tuple(a for a in ("pod", "data") if a in axes) or None
    rules = ShardingRules(batch=batch, fsdp="data" if "data" in axes else None,
                          tensor="model" if "model" in axes else None,
                          expert="model" if "model" in axes else None)
    return rules.replicated() if transport == "classical" else rules


def run(arch: Union[str, ModelConfig] = "qwen2-0.5b", *, smoke: bool = False, steps: int = 20, batch: int = 8,
        seq: int = 128, lr: float = 3e-4, opt: str = "adamw", micro: int = 1, ckpt: str = "",
        ckpt_every: int = 50, seed: int = 0, log_every: int = 5,
        strategy: str = "sfl_two_step", onus: int = PonConfig.n_onus,
        clients_per_onu: int = PonConfig.clients_per_onu, n_pons: int = PonConfig.n_pons,
        pon: Optional[PonConfig] = None, strategy_kwargs: Optional[dict] = None,
        overselect: float = 0.0, p_crash: float = 0.0, p_transient: float = 0.0,
        mean_recovery_rounds: float = 3.0, failure_seed: Optional[int] = None,
        compress: str = "none", device: str = "cuda") -> Dict[str, Any]:
    """Train ``steps`` rounds (fewer when resuming from ``ckpt``) of ``arch``,
    a config name or a ``ModelConfig`` (a named config cut to size, taken as
    it is: ``smoke`` does not apply). Under an initialized process group
    every rank calls it alike, and rank 0 alone prints and checkpoints.

    The topology is ``n_pons`` trees of ``onus`` ONUs × ``clients_per_onu``
    clients; ``pon`` gives the transport's other knobs (DBA, wavelengths,
    background load, engine). ``strategy_kwargs`` (the shared CLI's dict,
    ``fl.strategy_kwargs_from_args``) are filtered to what ``strategy``
    takes, with ``compress``.

    Returns {"history", "backend" (params, opt_state), "cfg", "start_step"}.
    """
    dev = device_mod.resolve(device)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    if isinstance(arch, ModelConfig):
        cfg = arch
    else:
        cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    flc = FLConfig(n_onus=onus, clients_per_onu=clients_per_onu, n_pons=n_pons,
                   pon=pon if pon is not None else PonConfig())
    name = fl.canonical_name(strategy)
    skw = fl.filter_strategy_kwargs(name, dict(strategy_kwargs or {}, compress=compress))
    exp = fl.ExperimentConfig(fl=flc, strategy=name, strategy_kwargs=tuple(sorted(skw.items())),
                              overselect=overselect, p_crash=p_crash,
                              p_transient=p_transient,
                              mean_recovery_rounds=mean_recovery_rounds,
                              failure_seed=failure_seed, n_rounds=steps, seed=seed)
    # one selected client per batch row: client_weight aligns with the batch
    exp = exp.with_fl(n_selected=batch)
    rng = np.random.default_rng(seed)
    onu_ids = np.arange(flc.n_clients) // flc.clients_per_onu
    sample_counts = rng.integers(50, 400, flc.n_clients).astype(np.float32)
    strat = exp.make_strategy()
    mesh = rules = None
    if dist.is_initialized():
        mesh = make_test_mesh((dist.get_world_size(), 1), ("data", "model"), dev.type)
        rules = build_rules(mesh, strat.transport)
    backend = fl.GradientBackend(cfg, strat, opt_name=opt, lr=lr,
                                 batch=batch, seq=seq, microbatches=micro, seed=seed,
                                 sample_counts=sample_counts, onu_ids=onu_ids, device=dev,
                                 mesh=mesh, rules=rules)

    def state():
        return (backend.params, backend.opt_state)

    step0 = 0
    if ckpt:
        last = latest_step(ckpt)
        if last is not None:
            (backend.params, backend.opt_state), _, step0 = restore_checkpoint(ckpt, last,
                                                                               state())
            say(f"[restore] resumed from step {step0}")

    def on_round(loop, rec):
        step = rec["round"]
        if step % log_every == 0 or step == steps - 1:
            say(f"step {step}: loss {rec['loss']:.4f} grad_norm {rec['grad_norm']:.4f} "
                  f"involved {rec['involved']:.0f}/{rec['n_selected']} upstream "
                  f"{rec['upstream_mbits']:.1f} Mb dt {rec['dt']:.3f}s")
        if ckpt and lead and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt, step + 1, state())

    # a resumed run asks for the remaining rounds; the loop replays the
    # skipped rounds' draws so the trajectory is the uninterrupted one
    loop = fl.RoundLoop(exp, backend, callbacks=[on_round])
    history = loop.run(max(0, steps - step0), start_round=step0)
    if ckpt and lead:
        save_checkpoint(ckpt, steps, state())
        say(f"[ckpt] saved final at step {steps}")
    return {"history": history, "backend": backend, "cfg": cfg, "start_step": step0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--opt", default="adamw", choices=["sgd", "sgdm", "adamw", "yogi"])
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--driver", default="loop",
                    help="loop (the RoundLoop); runtime is ROADMAP.md Queue 1 item 4")
    ap.add_argument("--strategy", default="sfl_two_step",
                    help=f"{'|'.join(fl.strategy_names())} (aliases: sfl, hier)")
    add_pon_cli_args(ap)
    fl.add_strategy_cli_args(ap)
    ap.add_argument("--overselect", type=float, default=0.0,
                    help="extra backup clients per round, fraction of N")
    ap.add_argument("--p-crash", type=float, default=0.0)
    ap.add_argument("--p-transient", type=float, default=0.0)
    ap.add_argument("--mean-recovery-rounds", type=float, default=3.0)
    ap.add_argument("--failure-seed", type=int, default=None)
    ap.add_argument("--compress", default="none", choices=SCHEMES,
                    help="wire compression the PON transport bills")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    for name in _REFUSED:
        ap.add_argument("--" + name.replace("_", "-"), default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for name, item in _REFUSED.items():
        value = getattr(args, name)
        if value is not None:
            ap.error(f"--{name.replace('_', '-')} is not ported yet: ROADMAP.md {item}")
    if args.driver != "loop":
        ap.error(f"--driver {args.driver} is not ported yet: ROADMAP.md Queue 1 item 4 "
                 "(the runtime)")
    # torchrun sets WORLD_SIZE: one process group for the run
    started = int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized()
    if started:
        if args.device == "cuda":
            device_mod.resolve("cuda")
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    try:
        run(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch, seq=args.seq,
            lr=args.lr, opt=args.opt, micro=args.micro, ckpt=args.ckpt,
            ckpt_every=args.ckpt_every, seed=args.seed, log_every=args.log_every,
            strategy=args.strategy, onus=args.onus, clients_per_onu=args.clients_per_onu,
            n_pons=args.n_pons, pon=pon_config_from_args(args),
            strategy_kwargs=fl.strategy_kwargs_from_args(args), overselect=args.overselect, p_crash=args.p_crash, p_transient=args.p_transient,
            mean_recovery_rounds=args.mean_recovery_rounds, failure_seed=args.failure_seed,
            compress=args.compress, device=args.device)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
