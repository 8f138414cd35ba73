"""RunReport — the one-file run bundle behind ``--report-out`` (port of
``repro.obs.audit.bundle``; bundles of either package load in either).

A bundle captures everything needed to compare two runs after the fact
(DESIGN.md §14): the resolved :class:`~repro_torch.fl.config.ExperimentConfig`
(nested FLConfig/PonConfig included) plus its content hash, the History
rows, the merged MetricsRegistry records, the health incidents, the
Chrome trace, and the environment (python, numpy, torch and CUDA versions,
the card). The
diff engine (:mod:`repro_torch.obs.audit.diff`) consumes two of these; the
HTML renderer turns the comparison into a self-contained report.

Everything in a bundle is plain JSON — no pickles, no custom binary —
so bundles stay machine-diffable across PRs and loadable without the
repo on the path.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import platform
import sys
from typing import Any, Dict, List, Optional

BUNDLE_SCHEMA = "repro.obs.audit/v1"


def _jsonable(v: Any) -> Any:
    """Coerce config/record values to plain JSON types (tuples → lists,
    numpy scalars → python, dataclasses → dicts)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {k: _jsonable(x) for k, x in dataclasses.asdict(v).items()}
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    if hasattr(v, "item"):            # numpy scalar
        return v.item()
    if hasattr(v, "tolist"):          # numpy array
        return v.tolist()
    return str(v)


def config_dict(cfg: Any) -> Dict[str, Any]:
    """The resolved config as a nested plain dict (ExperimentConfig with
    FLConfig/PonConfig inside; any dataclass works)."""
    return _jsonable(cfg)


def config_hash(d: Dict[str, Any]) -> str:
    """Content hash of a config dict: sha256 over the sorted-key JSON.
    Two runs with identical resolved configs hash identically regardless
    of how the config was built (CLI vs dataclass literal)."""
    blob = json.dumps(d, sort_keys=True, separators=(",", ":"), default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _env() -> Dict[str, Any]:
    """Python, platform, numpy, torch and its CUDA; the card's name once
    CUDA is initialised."""
    import numpy
    import torch
    env: Dict[str, Any] = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "numpy": numpy.__version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    if torch.cuda.is_initialized():
        env["device"] = torch.cuda.get_device_name(torch.cuda.current_device())
    return env


@dataclasses.dataclass
class RunReport:
    """One run, fully captured. Build with :meth:`from_run`, persist with
    :meth:`write`, reload with :meth:`load` (load returns plain dicts in
    every field — the diff engine only needs dict access)."""

    schema: str = BUNDLE_SCHEMA
    driver: str = ""                  # "round_loop" | "orchestrator" | bench
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    config_hash: str = ""
    seed: Optional[int] = None
    history: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    metrics: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    summary: Dict[str, Any] = dataclasses.field(default_factory=dict)
    incidents: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    trace: Dict[str, Any] = dataclasses.field(default_factory=dict)
    env: Dict[str, Any] = dataclasses.field(default_factory=dict)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_run(cls, cfg: Any = None, history: Any = None,
                 obs: Any = None, incidents: Optional[List] = None,
                 driver: str = "", extra: Optional[Dict] = None) -> "RunReport":
        """Assemble a bundle from live objects.

        ``history`` is a ``fl.History`` (or any iterable of row dicts),
        ``obs`` an :class:`~repro_torch.obs.context.Obs` (merged metrics +
        tracer are read from it), ``incidents`` a list of Incident
        records or dicts (HealthEngine.records() output).
        """
        cfgd = config_dict(cfg) if cfg is not None else {}
        reg = obs.merged_metrics() if obs is not None else None
        trc = getattr(obs, "tracer", None)
        rows = [_jsonable(r) for r in history] if history is not None else []
        incs = [i if isinstance(i, dict) else i.to_dict()
                for i in (incidents or [])]
        return cls(
            driver=driver,
            config=cfgd,
            config_hash=config_hash(cfgd) if cfgd else "",
            seed=cfgd.get("seed"),
            history=rows,
            metrics=reg.records() if reg is not None else [],
            summary=reg.summary() if reg is not None else {},
            incidents=incs,
            trace=(trc.to_chrome() if trc is not None
                   and getattr(trc, "enabled", False) else {}),
            env=_env(),
            extra=dict(extra or {}),
        )

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, default=float)
        return path

    @classmethod
    def load(cls, path: str) -> "RunReport":
        with open(path) as f:
            d = json.load(f)
        if d.get("schema") != BUNDLE_SCHEMA:
            raise ValueError(
                f"{path}: not a {BUNDLE_SCHEMA} bundle "
                f"(schema={d.get('schema')!r})")
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
