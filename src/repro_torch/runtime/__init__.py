"""repro_torch.runtime — the event-driven federated runtime on the PON clock
(port of ``repro.runtime``).

    from repro_torch import fl, runtime

    exp = fl.ExperimentConfig(policy="fedbuff", buffer_k=8)
    hist = runtime.Orchestrator(exp, backend).run(until_s=500.0)

``SimClock`` is the simulated wall clock; the ``Orchestrator`` schedules
client dispatch/training/upload lifecycles on it, feeding uploads to the
incremental PON event simulator; ``policies`` decide when the server
aggregates (sync deadline rounds, semi-sync straggler carry, fedbuff
buffered async with staleness weighting).

The Orchestrator/policies are loaded lazily (PEP 562): ``fl.config``
imports this package's ``failures`` module, and the orchestrator imports
``fl`` back — eager imports here would make that a cycle.
"""
from repro_torch.runtime.clock import SimClock
from repro_torch.runtime.failures import (FailureModel, MembershipTable,
                                          renormalized_weights)

__all__ = [
    "FailureModel", "MembershipTable", "renormalized_weights",
    "SimClock",
    "Orchestrator",
    "AggregationPolicy", "ClientUpdate", "make_policy", "canonical_policy",
    "policy_names", "staleness_weights",
]

_LAZY = {
    "Orchestrator": "repro_torch.runtime.orchestrator",
    "AggregationPolicy": "repro_torch.runtime.policies",
    "ClientUpdate": "repro_torch.runtime.policies",
    "make_policy": "repro_torch.runtime.policies",
    "canonical_policy": "repro_torch.runtime.policies",
    "policy_names": "repro_torch.runtime.policies",
    "staleness_weights": "repro_torch.runtime.policies",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
