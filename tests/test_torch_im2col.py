"""repro_torch's patch gather (``kernels.im2col``) for the FEMNIST CNN's 5×5
SAME convolutions: the plain route against ``F.unfold``, ``Im2colFn`` under
``vmap(grad_and_value)`` against the ``F.unfold`` form of ``conv5_same``
bit for bit, the wrapper's checks and cost, the kernel's tiling, a numpy
model of the kernel's block walk at that tiling, and the launch path
through a stand-in library. The ``cuda``-marked tests hold the kernel
against ``F.unfold`` on the card:
``python -m pytest -q -m cuda tests/test_torch_im2col.py``.
"""
import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from test_torch_stub_library import stub_libraries  # noqa: E402
from torch.func import grad_and_value, vmap  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data import femnist  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.models import femnist_cnn  # noqa: E402

# the module (the package exports its function of the same name)
ki = importlib.import_module("repro_torch.kernels.im2col")

H100_SMS = 132
# (B, C, H, W): conv1's and conv2's shapes in a 16-client chunk, and odd ones
SHAPES = [(1, 1, 28, 28), (160, 32, 14, 14), (7, 3, 5, 9)]


@pytest.fixture
def card():
    """Skips a ``cuda`` test where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _x(shape, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_route_equals_unfold(shape):
    x = _x(shape)
    got = ki.im2col(x)
    assert got.shape == (shape[0], shape[1] * 25, shape[2] * shape[3])
    assert torch.equal(got, F.unfold(x, 5, padding=2))


# ------------------------------------------- Im2colFn against the F.unfold form

def _clients(n_clients, batch, seed=3):
    clients, _ = femnist.generate(femnist.FemnistConfig(n_clients=n_clients, seed=seed))
    rng = np.random.default_rng(seed)
    mbs = [femnist.client_minibatches(rng, c, 1, batch) for c in clients]
    return {k: torch.from_numpy(np.stack([m[k][0] for m in mbs])) for k in mbs[0]}


def _stacked_params(cfg, n_clients):
    ps = [femnist_cnn.init_params(cfg, torch.Generator().manual_seed(s), device="cpu")
          for s in range(n_clients)]
    return {k: torch.stack([p[k] for p in ps]) for k in ps[0]}


def _vmapped_step(params, batch, in_dims):
    fn = grad_and_value(femnist_cnn.loss_fn, has_aux=True)
    return vmap(fn, in_dims=in_dims)(params, batch)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("layout", ["clients first", "clients second, shared params"])
def test_vmapped_grad_equals_the_unfold_form(monkeypatch, full, layout):
    """A chunk of 4 clients × batch 10 under vmap(grad_and_value): the loss,
    the accuracy and every leaf's gradient through ``Im2colFn`` equal the
    ``F.unfold`` form's bit for bit. The second layout vmaps the batch over
    its second axis and shares one set of parameters (in_dims None)."""
    cfg = configs.get("femnist_cnn")
    cfg = cfg if full else cfg.reduced()
    batch = _clients(4, 10)
    if layout == "clients first":
        params, in_dims = _stacked_params(cfg, 4), (0, 0)
    else:
        params = femnist_cnn.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
        batch = {k: v.movedim(0, 1).contiguous() for k, v in batch.items()}
        in_dims = (None, 1)
    calls = []
    real = ki.im2col
    monkeypatch.setattr(ki, "im2col", lambda x: calls.append(x.shape) or real(x))
    got = _vmapped_step(params, batch, in_dims)
    # the vmap rule gathers the whole chunk in one call a convolution
    assert calls == [(40, 1, 28, 28), (40, cfg.cnn_channels[0], 14, 14)]
    monkeypatch.setattr(femnist_cnn, "Im2colFn",
                        types.SimpleNamespace(apply=lambda x: F.unfold(x, 5, padding=2)))
    want = _vmapped_step(params, batch, in_dims)
    (g1, (loss1, aux1)), (g0, (loss0, aux0)) = got, want
    assert torch.equal(loss1, loss0) and torch.equal(aux1["acc"], aux0["acc"])
    assert g1.keys() == g0.keys() == params.keys()
    for k in params:
        assert torch.equal(g1[k], g0[k]), k


def test_images_get_no_gradient_and_conv2_its_fold():
    """Under plain autograd the first convolution's input (the images) asks
    for no gradient; the second's gradient is ``F.fold`` of the patches'."""
    x = _x((3, 2, 14, 14), 1).requires_grad_()
    g = _x((3, 50, 196), 2)
    (ki.Im2colFn.apply(x) * g).sum().backward()
    assert torch.equal(x.grad, F.fold(g, (14, 14), 5, padding=2))
    images = _x((3, 1, 28, 28))
    assert not ki.Im2colFn.apply(images).requires_grad


def _ranges(fn):
    with torch.profiler.profile() as p:
        fn()
    return {e.key: e.count for e in p.key_averages() if e.key.startswith("kernels.")}


def test_one_range_a_call_and_two_a_vmapped_step():
    """``kernels.im2col`` opens once a call: twice a vmap'd local step of a
    client chunk, one a convolution."""
    assert _ranges(lambda: ki.im2col(_x((2, 3, 14, 14)))) == {"kernels.im2col": 1}
    cfg = configs.get("femnist_cnn").reduced()
    params, batch = _stacked_params(cfg, 4), _clients(4, 10)
    assert _ranges(lambda: _vmapped_step(params, batch, (0, 0))) == {"kernels.im2col": 2}


# ------------------------------------------------------ checks, cost, tiling

@pytest.mark.parametrize("bad,err", [
    (lambda: _x((2, 3, 14, 14)).transpose(2, 3), ValueError),
    (lambda: _x((2, 3, 14, 14)).double(), TypeError),
    (lambda: _x((6, 14, 14)), ValueError),
])
def test_wrapper_rejects_bad_inputs(bad, err):
    with pytest.raises(err):
        ki.im2col(bad())


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        ki.im2col(torch.empty((2, 3, 14, 14), device="meta"))


def test_cost_at_the_conv2_chunk_shape():
    w = ki.im2col_cost(160, 32, 14, 14)
    assert w.bytes_read == 160 * 32 * 196 * 4 == 4_014_080
    assert w.bytes_written == 160 * 800 * 196 * 4 == 100_352_000
    assert w.bound()[1] == "bytes" and round(w.bound()[0], 4) == 0.0312


def test_counter_hears_one_im2col_a_convolution():
    cfg = configs.get("femnist_cnn").reduced()
    params = femnist_cnn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    images = _clients(1, 10)["images"][0]
    with roofline.Counter() as c:
        femnist_cnn.apply(params, images)
    k = c.kernels["im2col"]
    assert k["calls"] == k["launches"] == 2
    want = ki.im2col_cost(10, 1, 28, 28).nbytes + ki.im2col_cost(10, 4, 14, 14).nbytes
    assert k["bytes"] == want and not k["flops"]


@pytest.mark.parametrize("shape,want", [
    ((160, 32, 14, 14), ki.Tiling(14, 1, 4, 245)),   # conv2, a 16-client chunk
    ((160, 1, 28, 28), ki.Tiling(28, 5, 4, 196)),    # conv1, the same
    ((10, 1, 28, 28), ki.Tiling(28, 25, 4, 196)),    # one client's batch
    ((10, 32, 14, 14), ki.Tiling(14, 5, 4, 245)),
])
def test_tiling_at_the_main_paths_shapes(shape, want):
    assert ki.tiling(*shape, H100_SMS) == want


def _kernel_model(x: np.ndarray, t: ki.Tiling) -> np.ndarray:
    """``csrc/im2col.cu``'s walk in numpy: each block stages its band of a
    plane with a zero halo and writes its kernel rows from the staged band;
    every position is written once (NaN marks one never written)."""
    B, C, H, W = x.shape
    hw, pitch = H * W, W + 4
    planes = x.reshape(B * C, H * W)
    bands = -(-H // t.band)
    lanes = min(-(-t.band * W // t.vec), t.threads)
    side = t.threads // lanes
    rows = 25 // t.groups
    out = np.full(B * C * 25 * hw, np.nan, np.float32)
    written = np.zeros(out.size, np.int64)
    for blk in range(B * C * bands * t.groups):
        group, oh0 = blk % t.groups, (blk // t.groups) % bands * t.band
        plane = blk // (t.groups * bands)
        bh = min(t.band, H - oh0)
        i = np.arange((bh + 4) * pitch)
        ih, iw = oh0 - 2 + i // pitch, i % pitch - 2
        inside = (ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
        tile = np.where(inside, planes[plane, np.clip(ih * W + iw, 0, hw - 1)], 0.0)
        for tid in range(t.threads):
            lane, first = tid % lanes, tid // lanes
            if first >= side:
                continue
            j = np.arange(lane * t.vec, bh * W, lanes * t.vec)
            r = np.arange(group * rows + first, group * rows + rows, side)
            p = (j[:, None] + np.arange(t.vec)[None, :]).ravel()     # each j's positions
            off = p // W * pitch + p % W
            k = r // 5 * pitch + r % 5
            dst = plane * 25 * hw + r[:, None] * hw + oh0 * W + p[None, :]
            if t.vec == 4:
                assert (dst[:, ::4] % 4 == 0).all()                   # 16-byte stores
            out[dst] = tile[off[None, :] + k[:, None]]
            np.add.at(written, dst.ravel(), 1)
    assert (written == 1).all()
    return out.reshape(B, C * 25, hw)


@pytest.mark.parametrize("shape,sms", [
    ((2, 3, 14, 14), H100_SMS),    # 25 groups, one row a block
    ((3, 2, 28, 28), 1),           # one group, the whole plane a block
    ((4, 2, 28, 28), 2),           # 5 groups
    ((3, 2, 5, 9), 1),             # H·W = 45: the scalar variant
    ((1, 1, 3, 1), 1),             # narrower than the halo
    ((1, 1, 120, 120), 1),         # two bands of 92 and 28 rows
    ((1, 2, 121, 130), 1),         # banded, H·W odd: scalar
])
def test_kernel_model_equals_unfold(shape, sms):
    t = ki.tiling(*shape, sms)
    assert (t.band + 4) * (shape[3] + 4) <= ki.MAX_STAGED_FLOATS and t.threads <= 256
    x = _x(shape)
    got = _kernel_model(x.numpy(), t)
    assert np.array_equal(got, F.unfold(x, 5, padding=2).numpy())


def test_tiling_rejects_a_plane_too_wide_to_stage():
    with pytest.raises(ValueError, match="W <="):
        ki.tiling(1, 1, 8, 1600, H100_SMS)


# --------------------------------------- the launch path, through a stand-in

def test_launch_hands_the_kernel_its_tiling(monkeypatch):
    libs = stub_libraries(monkeypatch)
    monkeypatch.setattr(ki.cost, "device_kind", lambda name, t: "cuda")
    monkeypatch.setattr(ki, "_sms", lambda index: H100_SMS)
    before = ki.im2col.launches
    x = _x((160, 32, 14, 14))
    for _ in range(2):
        out = ki.im2col(x)
    assert ki.im2col.launches == before + 2 and out.shape == (160, 800, 196)
    lib = libs["im2col"]
    assert lib.calls == ["im2col5_f32"] * 2 and lib.bound == {"im2col5_f32": 1}
    assert lib.args[-1][:-1] == (x.data_ptr(), 160 * 32, 14, 14, 14, 1, 4, 245,
                                 out.data_ptr())


# ------------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_cuda_kernel_equals_unfold(card):
    """Bit for bit at the chunk shapes, eval's batch, one client's batch and
    shapes off the path (scalar variant, bands); one launch a call."""
    for shape in SHAPES + [(496, 1, 28, 28), (496, 32, 14, 14), (10, 1, 28, 28),
                           (3, 2, 121, 130), (2, 1, 120, 120), (1, 1, 3, 1)]:
        x = _x(shape, device="cuda")
        before = ki.im2col.launches
        got = ki.im2col(x)
        torch.cuda.synchronize()
        assert ki.im2col.launches == before + 1, shape
        assert torch.equal(got, F.unfold(x, 5, padding=2)), shape


@pytest.mark.cuda
def test_cuda_vmapped_step_equals_the_unfold_form(card, monkeypatch):
    cfg = configs.get("femnist_cnn")
    params = {k: v.cuda() for k, v in _stacked_params(cfg, 4).items()}
    batch = {k: v.cuda() for k, v in _clients(4, 10).items()}
    got = _vmapped_step(params, batch, (0, 0))
    monkeypatch.setattr(femnist_cnn, "Im2colFn",
                        types.SimpleNamespace(apply=lambda x: F.unfold(x, 5, padding=2)))
    want = _vmapped_step(params, batch, (0, 0))
    assert torch.equal(got[1][0], want[1][0])
    for k in params:
        assert torch.equal(got[0][k], want[0][k]), k
