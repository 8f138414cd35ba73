"""The federated round of the client-stacked regime: the paper's FEMNIST
CNN trained by every involved client for H local SGD steps, aggregated by
the traffic mix's strategy (two-step SFL over one PON, or k-step hier_sfl
over a forest with int8 at every tier), through ``fl.RoundLoop`` built as
``repro_torch.launch.femnist.run`` builds it.

End to end: ``setup_s`` (the process's start to the window's) and
``round_device_s`` (the seconds in which the card ran an operation during
the window, over the rounds completed in it); the window's wall over its
rounds is the per-layer ``fl.round_wall_s``. The first
``check_rounds`` rounds (the set-up's warm-up) are compared with the
plain reference after the window: the selection, involvement mask and
upstream Mbits exactly, then the numbers the cell's ``limits`` name. End
to end: the first round's update and the parameters' change after the
last, leaf by leaf. Stage by stage, where int8 rounding at the tiers
would swamp the end-to-end numbers: the first round's client rows, as
the program handed them to its aggregation, are copied to the host; the
reference compares their weighted mean with its own local training's,
and runs its own tiers on those rows with the same noise to compare the
program's update with, code by code.
"""
from __future__ import annotations

import math
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from portbench.harness import checks as chk
from portbench.harness import window
from portbench.harness.runner import Outcome
from portbench.inputs import femnist, noise, weights
from portbench.inputs.seeds import derive
from portbench.reference import fl as ref_fl
from portbench.reference import pon as ref_pon


def _norms(a: Dict[str, torch.Tensor], b: Optional[Dict[str, torch.Tensor]] = None
           ) -> Dict[str, float]:
    """Each leaf's norm of ``a − b`` (of ``a`` without ``b``)."""
    return {k: float(torch.linalg.vector_norm((v - b[k] if b is not None else v).float()))
            for k, v in a.items()}


# every number a cell's limits may name, in the order compared; the
# stage-by-stage ones need the first round's rows
NUMBERS = ("update_median_gap", "update_worst_gap", "deltas_median_gap", "deltas_worst_gap",
           "agg_flip_share", "change_worst_gap")
STAGED = ("deltas_median_gap", "deltas_worst_gap", "agg_flip_share")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class _Recording:
    """The program's strategy, with one aggregate call recorded into
    ``sink``: the involved clients' rows (the first, before the padding's)
    copied to the host, their weights and ONUs, the update the program made
    of them, and the seconds the copy took."""

    def __init__(self, inner, sink: Dict):
        self._inner, self._sink = inner, sink

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def aggregate(self, deltas, weights, mask, onu_ids, n_onus, **kw):
        agg, stats = self._inner.aggregate(deltas, weights, mask, onu_ids, n_onus, **kw)
        t = time.perf_counter()
        mask = _host(mask)
        n = int((mask > 0).sum())
        assert np.all(mask[:n] > 0), "involved rows come first"
        self._sink.update(
            rows={k: v[:n].to("cpu") for k, v in deltas.items()},
            w=torch.from_numpy(_host(weights)[:n].astype(np.float32)),
            onu=_host(onu_ids)[:n].copy(),
            agg={k: v.detach().to("cpu", copy=True) for k, v in agg.items()})
        self._sink["seconds"] = time.perf_counter() - t
        return agg, stats


def _chunks(sink: Dict, size: int = ref_fl.CHUNK):
    n = len(sink["w"])
    for lo in range(0, n, size):
        yield ({k: v[lo:lo + size] for k, v in sink["rows"].items()}, sink["w"][lo:lo + size],
               sink["onu"][lo:lo + size])


def build(cell, seed: int, dev: torch.device, data):
    """The program's RoundLoop over a ClientStackedBackend, from the
    benchmark's inputs."""
    from repro_torch import fl
    from repro_torch.core.fedavg import FLConfig
    from repro_torch.models import femnist_cnn
    from repro_torch.pon import PonConfig

    f, p = cell.traffic["fl"], cell.traffic["pon"]
    ref_pon.check_covered(p)
    clients, eval_set, p0 = data
    pon = PonConfig(n_onus=f["n_onus"], clients_per_onu=f["clients_per_onu"], n_pons=f["n_pons"],
                    sync_threshold_s=p["sync_threshold_s"], metro_rate_mbps=p["metro_rate_mbps"],
                    metro_latency_ms=p["metro_latency_ms"], **ref_pon.COVERED)
    flc = FLConfig(n_onus=f["n_onus"], clients_per_onu=f["clients_per_onu"], n_pons=f["n_pons"],
                   n_selected=f["n_selected"], local_steps=f["local_steps"],
                   local_batch=f["local_batch"], local_lr=f["local_lr"],
                   client_chunk=f["client_chunk"], sync_threshold_s=p["sync_threshold_s"],
                   pon=pon)
    skw = fl.filter_strategy_kwargs(f["strategy"], {"n_pons": f["n_pons"],
                                                    "compress": f["compress"]})
    backend = fl.ClientStackedBackend(
        flc, fl.make_strategy(f["strategy"], **skw), dict(p0), clients,
        {k: torch.from_numpy(v).to(dev) for k, v in eval_set.items()}, femnist_cnn.loss_fn,
        sample_counts=femnist.sample_counts(clients), eval_every=f["eval_every"])
    if backend._comp is not None:
        # the stochastic rounding's noise: the benchmark's, handed to the
        # reference too (the method CompressionState documents for it)
        noise_seed = derive(seed, "noise")
        backend._comp.uniform_noise = lambda call, shapes: noise.uniform(
            noise_seed, call, shapes, dev)
    exp = fl.ExperimentConfig(fl=flc, strategy=fl.canonical_name(f["strategy"]),
                              strategy_kwargs=tuple(sorted(skw.items())), n_rounds=1 << 30,
                              seed=derive(seed, "loop"))
    return fl.RoundLoop(exp, backend)


def make_data(cell, seed: int, dev: torch.device):
    f = cell.traffic["fl"]
    n_clients = f["n_pons"] * f["n_onus"] * f["clients_per_onu"]
    clients, eval_set = femnist.generate(n_clients, derive(seed, "femnist"),
                                         **cell.traffic["data"])
    return clients, eval_set, weights.cnn(cell.config, seed, dev)


def reference(cell, seed: int, dev: torch.device, clients, eval_set, tf32: bool = False,
              fault: Optional[str] = None) -> Dict:
    """The plain reference's replay of the first rounds, as the numbers
    compared: the transport's, each round's eval loss, the first round's
    update and the last round's change a leaf, the first round's weighted
    mean of its clients' deltas a leaf; and, to judge this replay when it
    stands in the program's place, the first round's update it made
    (``agg``) beside the sound tiers' update of the same rows (``judge``,
    ``steps``). ``tf32`` computes it in TF32 (the control), ``fault``
    plants one (``reference.fl.replay``)."""
    ref_fl.set_tf32(tf32)
    try:
        p0 = weights.cnn(cell.config, seed, dev)
        ref = ref_fl.replay(p0, clients, eval_set, cell.traffic, derive(seed, "loop"),
                            derive(seed, "noise"), cell.workload["check_rounds"], fault=fault)
    finally:
        ref_fl.set_tf32(False)
    first = ref["first"]
    return {"selected": ref["selected"], "mask": ref["mask"],
            "upstream_mbits": ref["upstream_mbits"], "eval_loss": ref["eval_loss"],
            "update": _norms(ref["params"][0], p0), "change": _norms(ref["params"][-1], p0),
            "mean": _norms(first["mean"]), "agg": ref["first_agg"], "judge": first["agg"],
            "steps": first["steps"]}


def compare(cell, prog: Dict, ref: Dict, every: bool = False) -> list:
    """The numbers compared, each beside its limit: the transport exactly,
    then those the cell's limits name (``every``: all that apply, for
    setting limits). End to end: the first round's update and the change
    after the last, by the median or the worst leaf. Stage by stage: the
    first round's weighted mean of the client deltas, by leaf, and the
    share of the update's int8 codes that the reference's tiers, run on the
    program's own rows, round otherwise. Each round's eval loss is printed
    beside the reference's but not compared: sound runs and the control
    read it alike (PERF.md §2)."""
    lim = cell.workload["limits"]
    leaves = chk.counted_leaves(ref["update"])
    pairs = [("update", prog["update"], ref["update"]), ("change", prog["change"], ref["change"])]
    if "mean" in prog:
        pairs.append(("deltas", prog["mean"], ref["mean"]))
    for what, a, b in pairs:
        gaps = chk.leaf_gaps(a, b, leaves)
        print(f"portbench: {what} gap by leaf " + " ".join(f"{k} {v:.2e}" for k, v in gaps.items()),
              file=sys.stderr)
    print("portbench: eval loss program " + " ".join(f"{x:.7g}" for x in prog["eval_loss"])
          + " reference " + " ".join(f"{x:.7g}" for x in ref["eval_loss"]), file=sys.stderr)
    numbers = {
        "update_median_gap": lambda: chk.median_leaf_gap(prog["update"], ref["update"], leaves),
        "update_worst_gap": lambda: chk.leaf_gap(prog["update"], ref["update"], leaves),
        "deltas_median_gap": lambda: chk.median_leaf_gap(prog["mean"], ref["mean"], leaves),
        "deltas_worst_gap": lambda: chk.leaf_gap(prog["mean"], ref["mean"], leaves),
        "agg_flip_share": lambda: (chk.flip_share(prog["agg"], prog["judge"], prog["steps"])
                                   if prog["steps"] is not None else math.nan),
        "change_worst_gap": lambda: chk.leaf_gap(prog["change"], ref["change"], leaves),
    }
    names = [n for n in NUMBERS if n in lim or (every and (n not in STAGED or "mean" in prog))]
    return [("transport_mismatches", float(chk.transport_mismatches(
        prog["selected"], prog["mask"], prog["upstream_mbits"],
        ref["selected"], ref["mask"], ref["upstream_mbits"])), 0.0)] + [
        (n, numbers[n](), lim.get(n, math.inf)) for n in names]


# the reference put in the program's place: the control (the nearest
# precision below the configuration's f32 with TF32 off) and planted faults
VARIANTS = {"control_tf32": {"tf32": True}, "fault_half_batch": {"fault": "half_batch"},
            "fault_alter_answer": {"fault": "alter_answer"}}


def readings(cell, seed: int, dev: torch.device) -> Dict[str, list]:
    """Each variant's numbers against the sound reference's, on one seed."""
    clients, eval_set, _ = make_data(cell, seed, dev)
    sound = reference(cell, seed, dev, clients, eval_set)
    return {name: compare(cell, reference(cell, seed, dev, clients, eval_set, **kw), sound,
                          every=True)
            for name, kw in VARIANTS.items()}


def run(cell, seed: int, seconds: float, trace: bool, device: str, t0: float) -> Outcome:
    from repro_torch import device as device_mod
    from repro_torch.obs.context import get as obs_get

    dev = device_mod.resolve(device)
    window.note("imports", t0)
    clients, eval_set, p0 = make_data(cell, seed, dev)
    window.note("inputs", t0)
    loop = build(cell, seed, dev, (clients, eval_set, p0))
    backend = loop.backend
    prog: Dict = {}
    sink: Dict = {"seconds": 0.0}
    strategy = backend.strategy
    if any(n in cell.workload["limits"] for n in STAGED):
        backend.strategy = _Recording(strategy, sink)

    def after_round(r: int) -> None:
        if r == 0:
            backend.strategy = strategy
            prog["update"] = _norms(backend.params, p0)
        prog["change"] = _norms(backend.params, p0)

    seen = window.first_rounds(loop, cell.workload["check_rounds"], after_round, t0)
    prog.update(seen, eval_loss=[row["eval_loss"] for row in seen["rows"]])
    del p0
    evals = obs_get().metrics.histogram("backend.eval_s")
    eval0 = evals.sum
    # the copy of the first round's rows is the comparison's, not set-up
    setup_s = time.perf_counter() - t0 - sink["seconds"]
    if "rows" in sink:
        print(f"portbench: first round's rows copied in {sink['seconds']:.3f} s, "
              "not counted in setup_s", file=sys.stderr)
    win = window.measure(loop, cell.workload["check_rounds"], seconds, dev)
    eval_s = evals.sum - eval0
    tr = (window.traced(loop, win["next_round"], cell.workload["trace_seconds"])
          if trace else None)
    del loop, backend, strategy
    window.release(dev)
    ref = reference(cell, seed, dev, clients, eval_set)
    if "rows" in sink:
        j = ref_fl.judge(_chunks(sink), cell.traffic, derive(seed, "noise"), 0, dev)
        prog.update(mean=_norms(j["mean"]), agg=sink["agg"], judge=j["agg"], steps=j["steps"])
    checks = compare(cell, prog, ref)
    rows = win["rows"]
    e2e = {"setup_s": setup_s}
    if win["device_busy_s"] is not None:
        e2e["round_device_s"] = win["device_busy_s"] / len(rows)
    return Outcome(
        e2e=e2e,
        attempted=len(rows),
        failed=sum(not math.isfinite(r.get("eval_loss", 0.0)) for r in rows), checks=checks,
        memory_peak_bytes=win["memory_peak_bytes"],
        context={"rows": rows, "window_s": win["window_s"], "eval_s": eval_s,
                 "device_busy_s": win["device_busy_s"],
                 "traced_rows": tr.steps if tr is not None else []},
        trace=tr)
