"""The LM gradient regime — the counterpart of ``repro/launch/train.py``:
one train step per federated round through the port's RoundLoop (``--driver
loop``) or the runtime's Orchestrator (``--driver runtime``, the sync
policy) and ``GradientBackend``, on one card or data parallel over the
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
the gradients' schedule (:func:`build_rules`): under ``sfl`` each rank
trains its FSDP shards of the parameters and the optimizer's state, and a
checkpoint holds the gathered leaves (it restores on any world); rank 0
alone prints and writes checkpoints. ``--strategy`` takes any registered strategy (``hier_sfl``
with ``--n-pons`` bills the metro forest's k-step transport) with
``--fedprox-mu``, ``--server-opt`` and ``--server-lr`` as the reference's.
``--compress`` scales the wire the PON transport bills, as in the
reference's gradient regime. ``--driver runtime`` runs the same rounds on
the Orchestrator's simulated clock (each log line gains ``t_sim``; a
resumed run replays as the RoundLoop does); ``GradientBackend`` is
sync-only, so another ``--policy`` raises ``TypeError``. The flag set is
the reference's shared one (``fl.add_experiment_cli_args``), observability
included: ``--trace-out``, ``--metrics-out``, ``--report-out`` (a run
bundle for ``python -m repro_torch.obs.diff``), ``--health``,
``--incidents-out`` and ``--slo-*``; under ``torchrun`` rank 0 alone writes
them. Records go through ``obs.logging`` (``--log-level``, ``--log-json``:
one JSON object a record).
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, device as device_mod, fl, obs
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.common.sharding import ShardingRules
from repro_torch.core.fedavg import FLConfig
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.obs import obs_logging
from repro_torch.pon import PonConfig, pon_config_from_args


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
        compress: str = "none", device: str = "cuda", driver: str = "loop",
        policy: str = "sync", window_s: Optional[float] = None,
        obs_bundle: Optional[obs.Obs] = None, logger=None) -> Dict[str, Any]:
    """Train ``steps`` rounds (fewer when resuming from ``ckpt``) of ``arch``,
    a config name or a ``ModelConfig`` (a named config cut to size, taken as
    it is: ``smoke`` does not apply). Under an initialized process group
    every rank calls it alike, and rank 0 alone prints and writes
    checkpoints; ``backend`` then holds the rank's shards under FSDP
    (``backend.layout.gather`` gives the full tree).

    ``driver`` is ``"loop"`` (the RoundLoop) or ``"runtime"`` (the
    Orchestrator under ``policy``, ``window_s`` simulated seconds a round;
    this backend is sync-only, so another policy raises ``TypeError``).

    The topology is ``n_pons`` trees of ``onus`` ONUs × ``clients_per_onu``
    clients; ``pon`` gives the transport's other knobs (DBA, wavelengths,
    background load, engine). ``strategy_kwargs`` (the shared CLI's dict,
    ``fl.strategy_kwargs_from_args``) are filtered to what ``strategy``
    takes, with ``compress``. ``obs_bundle`` is the driver's
    ``repro_torch.obs`` bundle (default: a child of the ambient one);
    ``logger`` takes the records (default: ``obs.logging.setup()``'s).

    Returns {"history", "backend" (params, opt_state), "cfg", "exp",
    "start_step"}.
    """
    dev = device_mod.resolve(device)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    if logger is None:
        logger = obs_logging.setup()
    say = logger.info if lead else (lambda *a, **k: None)
    json_mode = any(isinstance(h.formatter, obs_logging.JsonFormatter)
                    for h in logger.handlers)
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
                              failure_seed=failure_seed, n_rounds=steps, seed=seed,
                              policy=policy, round_window_s=window_s)
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

    layout = backend.layout

    def save(step):
        """Every rank under FSDP (rank 0 writes the gathered leaves), else
        rank 0 alone."""
        if layout is not None:
            save_checkpoint(ckpt, step, state(), group=layout.axis_groups,
                            sharding_tree=(layout.shards, layout.state_places(backend.opt_state)))
        elif lead:
            save_checkpoint(ckpt, step, state())

    def on_round(drv, rec):
        step = rec["round"]
        if lead and (step % log_every == 0 or step == steps - 1):
            if json_mode:
                obs_logging.log_round(logger, rec)
            else:
                t_sim = f" t_sim {rec['t_s']:.0f}s" if "t_s" in rec else ""
                logger.info(f"step {step}: loss {rec['loss']:.4f} grad_norm "
                            f"{rec['grad_norm']:.4f} involved {rec['involved']:.0f}/"
                            f"{rec['n_selected']} upstream {rec['upstream_mbits']:.1f} Mb "
                            f"dt {rec['dt']:.3f}s{t_sim}")
        if ckpt and (step + 1) % ckpt_every == 0:
            save(step + 1)

    if driver == "runtime":
        from repro_torch import runtime
        drv = runtime.Orchestrator(exp, backend, callbacks=[on_round], obs=obs_bundle)
    elif driver == "loop":
        drv = fl.RoundLoop(exp, backend, callbacks=[on_round], obs=obs_bundle)
    else:
        raise ValueError(f"driver {driver!r}: loop or runtime")
    step0 = 0
    if ckpt:
        last = latest_step(ckpt)
        if last is not None:
            places = (None if layout is None else
                      (layout.shards, layout.state_places(backend.opt_state)))
            (backend.params, backend.opt_state), _, step0 = restore_checkpoint(
                ckpt, last, state(), places)
            say(f"[restore] resumed from step {step0}")

    # a resumed run asks for the remaining rounds; either driver replays
    # the skipped rounds' draws so the trajectory is the uninterrupted one
    history = drv.run(max(0, steps - step0), start_round=step0)
    if ckpt:
        save(steps)
        say(f"[ckpt] saved final at step {steps}")
    return {"history": history, "backend": backend, "cfg": cfg, "exp": exp,
            "start_step": step0}


def main(argv=None) -> Dict[str, Any]:
    """The reference's CLI; returns :func:`run`'s dict."""
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
    ap.add_argument("--driver", choices=("loop", "runtime"), default="loop",
                    help="round driver: the lockstep RoundLoop or the event-driven "
                         "runtime Orchestrator (--policy picks the aggregation "
                         "policy; GradientBackend is sync-only)")
    fl.add_experiment_cli_args(ap)
    obs_logging.add_logging_cli_args(ap)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logger = obs_logging.logger_from_args(args)
    # torchrun sets WORLD_SIZE: one process group for the run
    started = int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized()
    if started:
        if args.device == "cuda":
            device_mod.resolve("cuda")
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    driver = "orchestrator" if args.driver == "runtime" else "round_loop"
    # every rank observes alike (observing moves no number); rank 0 alone
    # writes the artifacts
    lead = not dist.is_initialized() or dist.get_rank() == 0
    sess = obs.session_from_args(args, driver=driver) if lead else obs.session()
    res = {}
    try:
        res = run(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch, seq=args.seq,
            lr=args.lr, opt=args.opt, micro=args.micro, ckpt=args.ckpt,
            ckpt_every=args.ckpt_every, seed=args.seed, log_every=args.log_every,
            strategy=args.strategy, onus=args.onus, clients_per_onu=args.clients_per_onu,
            n_pons=args.n_pons, pon=pon_config_from_args(args),
            strategy_kwargs=fl.strategy_kwargs_from_args(args), overselect=args.overselect, p_crash=args.p_crash, p_transient=args.p_transient,
            mean_recovery_rounds=args.mean_recovery_rounds, failure_seed=args.failure_seed,
            compress=args.compress, device=args.device, driver=args.driver,
            policy=args.policy, window_s=args.window_s, obs_bundle=sess.obs,
            logger=logger)
    finally:
        # cfg / history feed the --report-out bundle (of what ran, should
        # run raise); finish also restores the ambient context
        sess.finish(cfg=res.get("exp"), history=res.get("history"))
        if started:
            dist.destroy_process_group()
    return res


if __name__ == "__main__":
    main()
