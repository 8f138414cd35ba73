"""Model parameters and model FLOPs of each configuration, from the
widths in its file (``portbench/configs/<name>.json``).

Model FLOPs count the operations the forward and backward passes need: 2
a multiply-add, the backward twice the forward, so a trained sample or
token costs 3× its forward. Recomputation (remat) is not counted.
"""
from __future__ import annotations

from typing import Dict, Tuple


def cnn_leaf_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """The LEAF CNN's leaves in the port's layout (conv weights OIHW)."""
    c1, c2 = cfg["conv_channels"]
    k = cfg["kernel"]
    feat = (cfg["image_size"] // 4) ** 2 * c2
    return {"conv1_w": (c1, cfg["in_channels"], k, k), "conv1_b": (c1,),
            "conv2_w": (c2, c1, k, k), "conv2_b": (c2,),
            "fc1_w": (feat, cfg["fc_width"]), "fc1_b": (cfg["fc_width"],),
            "fc2_w": (cfg["fc_width"], cfg["n_classes"]), "fc2_b": (cfg["n_classes"],)}


def cnn_params(cfg: Dict) -> int:
    total = 0
    for shape in cnn_leaf_shapes(cfg).values():
        n = 1
        for s in shape:
            n *= s
        total += n
    return total


def cnn_forward_flops(cfg: Dict) -> int:
    """One sample's forward: the two SAME 5×5 convolutions (the second on
    the pooled half-size map) and the two dense layers, 2 a multiply-add."""
    c1, c2 = cfg["conv_channels"]
    k, img = cfg["kernel"], cfg["image_size"]
    conv1 = img * img * c1 * cfg["in_channels"] * k * k
    conv2 = (img // 2) ** 2 * c2 * c1 * k * k
    feat = (img // 4) ** 2 * c2
    dense = feat * cfg["fc_width"] + cfg["fc_width"] * cfg["n_classes"]
    return 2 * (conv1 + conv2 + dense)


def cnn_train_flops_per_sample(cfg: Dict) -> int:
    return 3 * cnn_forward_flops(cfg)


def lm_params(cfg: Dict) -> int:
    """Decoder parameters: the (tied) embedding, attention's four
    projections and the SwiGLU MLP's three a layer; the non-parametric
    LayerNorm has none."""
    d, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // H
    ff = cfg["intermediate_size"]
    attn = d * hd * (H + 2 * KV) + H * hd * d
    mlp = 3 * d * ff
    embed = V * d * (1 if cfg["tie_word_embeddings"] else 2)
    return embed + L * (attn + mlp)


def lm_train_flops_per_token(cfg: Dict, seq: int) -> int:
    """6 a parameter a token, plus causal attention's QKᵀ and P·V over the
    S/2 keys a query sees on average: 6·L·S·d a token."""
    return 6 * lm_params(cfg) + 6 * cfg["num_hidden_layers"] * seq * cfg["hidden_size"]
