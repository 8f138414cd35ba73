"""The comparison that decides ``correct``: numbers the program produced
on its timed path against the plain reference's, each against its limit.

A training run is compared over its first steps (rounds): the norm of the
first update as the optimizer got it, and the norm of the parameters'
change after the last compared step. Norms are taken leaf by leaf: the
gap between the program's norm and the reference's, over the larger of
the reference's norm of that leaf and the median leaf's; the worst leaf's
gap, or the median leaf's where the worst is the noise of a few small
leaves (then the worst leaf is held too, at a looser limit). Leaves whose
reference gradient is nought to rounding (under a thousandth of the
median leaf's) move by round-off alone and are left out, by that rule and
never by name. Where int8 rounding would swamp those norms, the stage
after local training is compared code by code (:func:`flip_share`).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Check = Tuple[str, float, float]          # (name, value, limit)
SKIP_BELOW = 1e-3                         # of the median leaf's reference gradient


def transport_mismatches(prog_sel: Sequence[np.ndarray], prog_mask: Sequence[np.ndarray],
                         prog_mbits: Sequence[float], ref_sel: Sequence[np.ndarray],
                         ref_mask: Sequence[np.ndarray], ref_mbits: Sequence[float]) -> int:
    """Rounds whose selection, involvement mask or upstream Mbits differ at
    all (an exact comparison)."""
    bad = 0
    for ps, pm, pb, rs, rm, rb in zip(prog_sel, prog_mask, prog_mbits, ref_sel, ref_mask,
                                      ref_mbits, strict=True):
        same = (np.array_equal(np.asarray(ps), np.asarray(rs))
                and np.array_equal(np.asarray(pm, np.float32), np.asarray(rm, np.float32))
                and float(pb) == float(rb))
        bad += not same
    return bad


def counted_leaves(ref_grad_norms: Dict[str, float]) -> List[str]:
    med = float(np.median(list(ref_grad_norms.values())))
    return [k for k, v in ref_grad_norms.items() if v >= SKIP_BELOW * med]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves: Sequence[str]
              ) -> Dict[str, float]:
    """Each counted leaf's |‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    med = float(np.median([ref[k] for k in leaves]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], leaves: Sequence[str]) -> float:
    """The worst counted leaf's gap (:func:`leaf_gaps`)."""
    return _finite_max(list(leaf_gaps(prog, ref, leaves).values()))


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float], leaves: Sequence[str]
                    ) -> float:
    """The median counted leaf's gap: steady where a few small leaves carry
    most of the rounding that local SGD amplifies (PERF.md §2)."""
    gaps = list(leaf_gaps(prog, ref, leaves).values())
    return math.inf if _finite_max(gaps) == math.inf else float(np.median(gaps))


def flip_share(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               steps: Dict[str, float]) -> float:
    """The share of an int8-rounded update's elements, over every leaf,
    where the program's and the reference's differ by a quarter of the
    leaf's last rounding step or more (or are not finite): a code that
    rounded the other way. f32 rounding alone moves an element by far less
    than a quarter step."""
    bad = total = 0
    for k, r in ref.items():
        near = (prog[k].to(r.device) - r).abs() < 0.25 * steps[k]
        bad += int((~near).sum())
        total += near.numel()
    return bad / max(total, 1)


def _finite_max(xs: Sequence[float]) -> float:
    if not xs or any(not math.isfinite(x) for x in xs):
        return math.inf
    return max(xs)


def passed(checks: Sequence[Check]) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)
