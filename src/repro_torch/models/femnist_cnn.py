"""The paper's FEMNIST model: LEAF's CNN — two 5x5 conv layers (+ maxpool),
one dense layer, 62-way classifier — the port of ``repro.models.femnist_cnn``.

Layouts: images arrive NHWC, as in the reference, and are permuted to
NCHW for the convolutions; conv weights are held OIHW (``bridge`` converts
from the reference's HWIO). Before the dense layer the activations go back
to NHWC so the flatten runs in (H, W, C) order and ``fc1_w`` keeps the
reference's row order: both packages then hold the same dense weights.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import device as device_mod
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]


def femnist_config() -> ModelConfig:
    return ModelConfig(
        name="femnist_cnn", family="cnn", n_layers=2, d_model=0, n_heads=0,
        n_kv_heads=0, d_ff=0, vocab_size=0, dtype="float32",
        img_size=28, n_classes=62, cnn_channels=(32, 64), cnn_fc=2048,
    )


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: str | torch.device = "cuda") -> Params:
    """Random parameters with the reference's per-leaf scale.

    The reference's ParamBuilder draws std = scale / sqrt(shape[0]) on the
    JAX shape. For an HWIO conv weight shape[0] is the kernel height (5),
    not the fan-in; that is copied as it is, so the port trains the same
    model. Draws come from ``generator`` on the CPU (seed 0 by default) and
    are then moved, so a seed gives the same weights on every device.
    """
    dev = device_mod.resolve(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dtype = getattr(torch, cfg.dtype)
    c1, c2 = cfg.cnn_channels
    feat = (cfg.img_size // 4) ** 2 * c2

    def normal(shape, scale, jax_dim0):
        std = scale / math.sqrt(jax_dim0)
        return torch.randn(shape, generator=generator) * std

    params = {
        "conv1_w": normal((c1, 1, 5, 5), 0.63, 5),
        "conv1_b": torch.zeros(c1),
        "conv2_w": normal((c2, c1, 5, 5), 0.11 * math.sqrt(32.0 / c1), 5),
        "conv2_b": torch.zeros(c2),
        "fc1_w": normal((feat, cfg.cnn_fc), 1.0, feat),
        "fc1_b": torch.zeros(cfg.cnn_fc),
        "fc2_w": normal((cfg.cnn_fc, cfg.n_classes), 1.0, cfg.cnn_fc),
        "fc2_b": torch.zeros(cfg.n_classes),
    }
    return {k: v.to(device=dev, dtype=dtype) for k, v in params.items()}


def conv5_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """5x5 convolution, SAME padding, stride 1, as an f32 matmul over the
    unfolded patches: x (B, C, H, W), w (O, C, 5, 5) -> (B, O, H, W).

    Not ``F.conv2d``: on an H100 the weight-gradient algorithm that cuDNN's
    heuristic picks for this CNN's shapes errs by up to 3e-3 of its largest
    entry, whatever the TF32 flags say (``chip_smoke.py`` measures it),
    where the reference computes in f32. The matmul form is exact to f32
    rounding on every device.
    """
    n, _, h, wd = x.shape
    cols = F.unfold(x, 5, padding=2)                       # (B, C·25, H·W)
    y = w.reshape(w.shape[0], -1) @ cols                   # (B, O, H·W)
    return (y + b[:, None]).reshape(n, w.shape[0], h, wd)


def apply(params: Params, images: torch.Tensor) -> torch.Tensor:
    """images: (B, 28, 28, 1) float32, NHWC -> logits (B, 62)."""
    x = images.permute(0, 3, 1, 2)
    # SAME padding for a 5x5 kernel at stride 1; VALID 2x2 max pool
    x = F.max_pool2d(F.relu(conv5_same(x, params["conv1_w"], params["conv1_b"])), 2)
    x = F.max_pool2d(F.relu(conv5_same(x, params["conv2_w"], params["conv2_b"])), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["fc1_w"] + params["fc1_b"])
    return x @ params["fc2_w"] + params["fc2_b"]


def loss_fn(params: Params, batch: Dict[str, torch.Tensor]):
    """Masked mean cross-entropy and accuracy -> (loss, {"acc": acc})."""
    logits = apply(params, batch["images"])
    labels = batch["labels"].long()          # int32 in the data; gather wants int64
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    denom = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / denom
    acc = ((logits.argmax(-1) == labels).float() * mask).sum() / denom
    return loss, {"acc": acc}


class FemnistCNN(nn.Module):
    """``nn.Module`` view of the functional model (same parameters, names)."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in init_params(cfg, generator, device).items()})

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return apply(dict(self.params), images)
