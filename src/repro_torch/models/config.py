"""Unified model configuration — a copy of ``repro.models.config.ModelConfig``.

The port keeps its own copy (pure dataclasses, no framework code) so it
imports nothing of the JAX package: every field, the language-model
layer-plan properties (parameter counts, active ones too) and
``reduced()``; and the assignment's input shapes (``ShapeConfig``,
``ALL_SHAPES``, ``shape_by_name``).
``tests/test_torch_femnist_cnn.py`` and ``tests/test_torch_lm.py`` hold
the two copies field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|audio|vlm|hybrid|ssm|cnn
    n_layers: int
    d_model: int
    n_heads: int                   # query heads (0 for attention-free archs)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False   # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25
    moe_impl: str = "scatter"      # scatter|einsum (einsum = small-test oracle)
    moe_seq_chunks: int = 1        # dispatch in sequence chunks
    moe_combine: str = "gather"    # gather|gather_dshard

    # --- attention details ---
    qkv_bias: bool = False
    rope_theta: float = 1e4
    window: int = 0                # sliding window for 'attn' layers; 0 = global
    norm: str = "rms"              # rms|ln|nonparam  (olmo: nonparam)
    mlp: str = "swiglu"            # swiglu|gelu
    logit_softcap: float = 0.0

    # --- hybrid / ssm ---
    block_pattern: Tuple[str, ...] = ("attn",)  # repeating unit of layer kinds
    rnn_width: int = 0             # RG-LRU recurrence width (0 -> d_model)
    conv_width: int = 4            # RG temporal conv
    rwkv_head_dim: int = 64
    rwkv_lora: int = 64            # LoRA rank for data-dependent decay

    # --- modality frontends (precomputed embeddings) ---
    frontend: str = "tokens"       # tokens|frames|patches
    n_frontend_tokens: int = 0     # image tokens available to cross-attn
    cross_attn_period: int = 0     # every k-th layer cross-attends (vlm)

    # --- numerics / performance knobs ---
    dtype: str = "bfloat16"
    remat: str = "full"            # none|full|dots
    q_chunk: int = 512             # attention query-block size
    loss_chunks: int = 4           # sequence chunks for the softmax-xent
    scan_layers: bool = True       # scan over layer units (False = unroll)
    attn_accounting: bool = False  # unrolled static-causal attention
    rwkv_chunk: int = 128
    tie_embeddings: bool = False
    tp_pad_heads: bool = True
    shard_kv_mha: bool = True

    # --- CNN (paper's FEMNIST model) ---
    img_size: int = 28
    n_classes: int = 62
    cnn_channels: Tuple[int, ...] = (32, 64)
    cnn_fc: int = 2048

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)

    # ---- layer plan -------------------------------------------------------
    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def tail_pattern(self) -> Tuple[str, ...]:
        rem = self.n_layers % len(self.block_pattern)
        return self.block_pattern[:rem]

    @property
    def is_subquadratic(self) -> bool:
        """True if decode cost per token is O(1) in history length.

        Requires every layer kind to be recurrent or windowed attention.
        """
        for kind in set(self.block_pattern):
            if kind in ("attn", "cross") and self.window == 0:
                return False
        return True

    @property
    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        n_attn = n_cross = n_rglru = n_rwkv = 0
        full = list(self.block_pattern) * self.n_units + list(self.tail_pattern)
        for k in full:
            n_attn += k == "attn"
            n_cross += k == "cross"
            n_rglru += k == "rglru"
            n_rwkv += k == "rwkv"
        attn_p = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        mlp_p = 3 * d * ff if self.mlp == "swiglu" else 2 * d * ff
        if self.n_experts:
            moe_p = self.n_experts * mlp_p + d * self.n_experts
            mlp_total = moe_p + (mlp_p if self.dense_residual else 0)
        else:
            mlp_total = mlp_p
        rg_w = self.rnn_width
        rglru_p = d * rg_w * 3 + rg_w * d + rg_w * (self.conv_width + 4) + 2 * rg_w * rg_w
        rwkv_p = 4 * d * d + d * self.rwkv_lora * 10 + 3 * d * ff // 2  # approx
        total = V * d * (1 if self.tie_embeddings else 2)
        total += n_attn * (attn_p + mlp_total)
        total += n_cross * (attn_p + mlp_total)
        total += n_rglru * (rglru_p + mlp_total)
        total += n_rwkv * rwkv_p
        return int(total)

    @property
    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count
        d, ff = self.d_model, self.d_ff
        mlp_p = 3 * d * ff if self.mlp == "swiglu" else 2 * d * ff
        inactive = (self.n_experts - self.top_k) * mlp_p * self.n_layers
        return int(self.param_count - inactive)

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized config of the same family (CPU-runnable)."""
        small = dict(
            n_layers=max(2, len(self.block_pattern)),
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128,
            vocab_size=256,
            n_experts=8 if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            rnn_width=64,
            rwkv_head_dim=16,
            rwkv_lora=8,
            n_frontend_tokens=16 if self.n_frontend_tokens else 0,
            q_chunk=16,
            rwkv_chunk=8,
            loss_chunks=1,
            name=self.name + "-smoke",
        )
        if self.family == "cnn":
            small = dict(name=self.name + "-smoke", cnn_fc=64, cnn_channels=(4, 8))
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train|prefill|decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_by_name(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
