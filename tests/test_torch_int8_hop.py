"""The ``two_step_int8`` transport's cross-pod hop: each data rank sends its
own shard of the pod-summed leaf as int8, at the whole leaf's scale.

The values are those of quantizing the whole pod-summed leaf (held here
bit for bit on a (pod 2, data 2) gloo world, and against the reference's
step by ``tests/test_torch_collectives.py``); the wire is 1/|data| of it:
the dry run's "pod" bytes of a reduced olmo-1b step on (pod 2, data 4)
are the shards' int8 bytes and one scale a leaf, at least 3× under gspmd
two-step's f32 shards.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.common import sharding  # noqa: E402
from repro_torch.common.tree import flatten  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import segments  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from test_torch_collectives import _spawn  # noqa: E402

POD, DATA = 2, 4
SHAPE = ShapeConfig("t", 16, 8, "train")
# leaf shapes: a multiple of |data|, ragged ones (padded), a scalar
LEAVES = ((8, 6), (7, 5), (3,), ())


def _pod_bytes(transport):
    cfg = configs.get_smoke("olmo-1b", dtype="float32")
    c = segments.count_step(cfg, SHAPE, {"pod": POD, "data": DATA},
                            sharding.ShardingRules(), "sgd", 1, transport)
    return c.coll["pod"], cfg


def test_int8_hop_sends_each_data_rank_shard():
    """Reckoned on ``meta``: per leaf the shard's ⌈n / |data|⌉ int8 bytes
    and one f32 scale cross "pod" (an all-gather over 2 pods moves half its
    output a rank), plus the (Σ nll, K) pair's all-reduce; ≥ 3× under
    gspmd two-step's f32 shards."""
    int8, cfg = _pod_bytes("two_step_int8")
    f32, _ = _pod_bytes("gspmd")
    params = transformer.abstract_params(cfg)[0]
    share = (POD - 1) / POD
    want = sum(math.ceil(x.numel() / DATA) * POD * share + 4 * POD * share
               for x in flatten(params)) + 2 * 8 * share
    assert int8 == want
    assert 3 * int8 <= f32, (int8, f32)
    print(f"pod bytes, reduced olmo-1b on (pod {POD}, data {DATA}): two_step_int8 "
          f"{int8:,.0f}, gspmd two-step {f32:,.0f} ({f32 / int8:.2f}x)")


def _hop_ranks(rank, world):
    """Each leaf through the shard form and through the whole-leaf form
    (the data all-reduce, then ``int8_pod_sum``): (shard, whole, this
    rank's leaf, pod-summed noise-free leaf)."""
    from repro_torch.core.aggregation import (all_reduce, int8_pod_sum,
                                              int8_two_step_leaf)
    mesh = mesh_mod.make_test_mesh((2, 2), ("pod", "data"), "cpu")
    data_g = mesh_mod.axes_group(mesh, ("data",))
    pod_g = mesh_mod.axes_group(mesh, ("pod",))
    out = []
    for i, shape in enumerate(LEAVES):
        x = torch.randn(shape, generator=torch.Generator().manual_seed(100 * i + rank))
        u = torch.rand(shape, generator=torch.Generator().manual_seed(7 + i))   # alike
        whole = int8_pod_sum(all_reduce(x, data_g), u, pod_g)
        out.append((int8_two_step_leaf(x, u, data_g, pod_g).numpy(), whole.numpy(),
                    x.numpy(), u.numpy()))
    return out


def test_int8_hop_values_equal_the_whole_leaf_form(tmp_path):
    """On (pod 2, data 2) gloo ranks the shard form equals quantizing the
    whole pod-summed leaf bit for bit, on every rank, and the numpy oracle
    Σ_p round(S_p / s_p + u − 0.5) · s_p with s_p the pod sum's absmax / 127."""
    ranks = _spawn(tmp_path, 4, _hop_ranks)
    for i, shape in enumerate(LEAVES):
        for r in ranks:
            got, whole = r[i][0], r[i][1]
            assert got.shape == shape
            np.testing.assert_array_equal(got, whole)
            np.testing.assert_array_equal(got, ranks[0][i][0])
        u = ranks[0][i][3].astype(np.float32)
        want = np.zeros(shape, np.float32)
        for pod in range(2):           # ranks are pod-major: (pod, data)
            s = (ranks[2 * pod][i][2] + ranks[2 * pod + 1][i][2]).astype(np.float32)
            scale = np.float32(max(np.abs(s).max(), 1e-12)) / np.float32(127.0)
            q = np.clip(np.round(s / scale + (u - np.float32(0.5))), -127, 127)
            want = want + q.astype(np.float32) * scale
        np.testing.assert_allclose(ranks[0][i][0], want, rtol=1e-6, atol=1e-6)
