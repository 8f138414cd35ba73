"""A kernel range's share of the frozen bound of its calls, in the traced
window, for the readers in ``metrics/``."""
from __future__ import annotations

import math
from typing import Callable, Optional

from portbench.work.models import cnn_leaf_shapes


def segment_aggregate(ctx, range_name: str, work: Callable) -> Optional[float]:
    """A segmented aggregate of the CNN's leaves: each traced round with an
    involved client makes one call a leaf, C = the round's rows padded to
    the client chunk, N = the leaf's size, one segment an ONU of the
    forest. The bound of those calls over the device time of the kernels
    launched inside the wrapper's ``range_name`` ranges; None where the
    trace saw no such call or another count of them."""
    tr, fl = ctx["trace"], ctx["traffic"]["fl"]
    if tr is None:
        return None
    secs = tr.range_device_s.get(range_name, 0.0)
    sizes = [math.prod(s) for s in cnn_leaf_shapes(ctx["config"]).values()]
    rounds = [r for r in ctx["traced_rows"] if r["involved"] > 0]
    if secs <= 0 or tr.range_calls.get(range_name) != len(sizes) * len(rounds):
        return None
    chunk, n_seg = fl["client_chunk"], fl["n_pons"] * fl["n_onus"]
    bound = sum(work(math.ceil(r["involved"] / chunk) * chunk, n, n_seg, 4).bound_s()
                for r in rounds for n in sizes)
    return 100.0 * bound / secs
