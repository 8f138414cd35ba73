"""Structured logging — one stdlib setup shared by the launch drivers
(port of ``repro.obs.logging``).

``launch.train`` (``--log-level``/``--log-json``) routes its per-round
records through here instead of bare prints:

  * human mode — a single line a record on stdout (``launch.train``
    keeps its own step line there);
  * ``--log-json`` — one JSON object per record (ts/level/logger/msg plus
    every structured field), greppable and ingestible.

:func:`log_round` formats a History record either way: the reference's
human line, or the whole record as JSON.
"""
from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Dict


class JsonFormatter(logging.Formatter):
    """One JSON object per line; dict messages merge their fields in."""

    def format(self, record: logging.LogRecord) -> str:
        out: Dict[str, Any] = {
            "ts": round(time.time(), 3),
            "level": record.levelname.lower(),
            "logger": record.name,
        }
        if isinstance(record.msg, dict):
            out["msg"] = record.msg.pop("msg", "record")
            out.update(record.msg)
        else:
            out["msg"] = record.getMessage()
        extra = getattr(record, "fields", None)
        if extra:
            out.update(extra)
        return json.dumps(out, default=float)


def setup(level: str = "info", json_mode: bool = False,
          stream=None, name: str = "repro_torch") -> logging.Logger:
    """Configure and return the shared ``repro_torch`` logger (idempotent:
    re-running replaces the handler rather than stacking duplicates)."""
    logger = logging.getLogger(name)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    for h in list(logger.handlers):
        logger.removeHandler(h)
    handler = logging.StreamHandler(stream if stream is not None
                                    else sys.stdout)
    if json_mode:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(handler)
    logger.propagate = False
    return logger


def _human_round_line(rec: Dict[str, Any]) -> str:
    """The classic train.py step line, built from a History record."""
    step = rec.get("round", "?")
    parts = [f"step {step:5d}" if isinstance(step, int) else f"step {step}"]
    if "loss" in rec:
        parts.append(f"loss {rec['loss']:.4f}")
    if "acc" in rec:
        parts.append(f"acc {rec['acc']:.3f}")
    if "involved" in rec:
        n = rec.get("n_selected")
        parts.append(f"involved {int(rec['involved'])}"
                     + (f"/{n}" if n is not None else ""))
    if "upstream_mbits" in rec:
        parts.append(f"upstream {rec['upstream_mbits']:.0f} Mb")
    if "dt" in rec:
        parts.append(f"dt {rec['dt']:.2f}s")
    if "t_s" in rec:
        parts.append(f"t_sim {rec['t_s']:.0f}s")
    return " ".join(parts)


def log_round(logger: logging.Logger, rec: Dict[str, Any],
              level: int = logging.INFO) -> None:
    """Emit one History record: human line, or the full record as JSON."""
    if not logger.isEnabledFor(level):
        return
    if any(isinstance(h.formatter, JsonFormatter) for h in logger.handlers):
        logger.log(level, dict(rec, msg="round"))
    else:
        logger.log(level, _human_round_line(rec))


def add_logging_cli_args(ap) -> None:
    """--log-level/--log-json, shared by any driver that calls setup()."""
    g = ap.add_argument_group("logging (repro_torch.obs.logging)")
    g.add_argument("--log-level", default="info",
                   choices=("debug", "info", "warning", "error"),
                   help="stdlib logging level for driver records")
    g.add_argument("--log-json", action="store_true",
                   help="emit one JSON object per record instead of the "
                        "human-readable line")


def logger_from_args(args, name: str = "repro_torch") -> logging.Logger:
    return setup(level=getattr(args, "log_level", "info"),
                 json_mode=bool(getattr(args, "log_json", False)),
                 name=name)
