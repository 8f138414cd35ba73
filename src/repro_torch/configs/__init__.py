"""Architecture registry of the port: ``get(name)`` returns a ModelConfig,
``get_smoke(name)`` its reduced same-family config (CPU-sized).

Ported so far: the paper's FEMNIST CNN and the language models whose
serving path runs through the port's kernels — recurrentgemma-9b (flash
attention + RG-LRU), rwkv6-3b (RWKV6) — plus qwen2-0.5b, used at reduced
width to pin the GQA head map, the QKV bias and tied embeddings. Each
entry is a copy of ``repro.configs.<name>.CONFIG``; the names and aliases
are the reference's.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.femnist_cnn import femnist_config


def recurrentgemma_9b() -> ModelConfig:
    """[arXiv:2402.19427] 38L d_model=4096 16H (MQA kv=1) d_ff=12288
    vocab=256000; unit (rglru, rglru, attn) x 12 + tail (rglru, rglru);
    attention layers use a 2048-token sliding window."""
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
        vocab_size=256000, head_dim=256, window=2048,
        block_pattern=("rglru", "rglru", "attn"),
    )


def rwkv6_3b() -> ModelConfig:
    """[arXiv:2404.05892] 32L d_model=2560 (attention-free) d_ff=8960
    vocab=65536; head_dim=64 -> 40 wkv heads (padded to 48)."""
    return ModelConfig(
        name="rwkv6-3b", family="ssm",
        n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=8960,
        vocab_size=65536, block_pattern=("rwkv",), rwkv_head_dim=64,
        norm="ln", rwkv_chunk=64,
    )


def qwen2_0_5b() -> ModelConfig:
    """[arXiv:2407.10671] 24L d_model=896 14H (GQA kv=2) d_ff=4864
    vocab=151936, QKV bias, tied embeddings."""
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
        vocab_size=151936, qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    )


_REGISTRY = {"femnist_cnn": femnist_config, "recurrentgemma_9b": recurrentgemma_9b,
             "rwkv6_3b": rwkv6_3b, "qwen2_0_5b": qwen2_0_5b}
_ALIASES = {"recurrentgemma-9b": "recurrentgemma_9b", "rwkv6-3b": "rwkv6_3b",
            "qwen2-0.5b": "qwen2_0_5b"}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get(name: str) -> ModelConfig:
    key = canonical(name)
    if key not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; ported: {sorted(_REGISTRY)}")
    return _REGISTRY[key]()


def get_smoke(name: str, **overrides) -> ModelConfig:
    return get(name).reduced(**overrides)
