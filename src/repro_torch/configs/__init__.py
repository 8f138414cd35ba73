"""Architecture registry of the port: ``get(name)`` returns a ModelConfig,
``get_smoke(name)`` its reduced same-family config (CPU-sized).

Every config of the reference: the paper's FEMNIST CNN, the language
models whose serving path runs through the port's kernels —
recurrentgemma-9b (flash attention + RG-LRU), rwkv6-3b (RWKV6) — the
dense models of the LM gradient regime: qwen2-0.5b and olmo-1b (trained
at full width on one card), olmo-100m (the training example's model),
and qwen1.5-110b and deepseek-coder-33b, which need no new model code but
do not fit one card (they train sharded over several: FSDP over "data",
tensor parallelism over "model"); and the families of the MoE block, the
frame frontend and cross-attention: qwen3-moe-30b-a3b, arctic-480b,
musicgen-large and llama-3.2-vision-90b. Each entry is a copy of
``repro.configs.<name>.CONFIG``; the names and aliases are the
reference's.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig
from repro_torch.models.femnist_cnn import femnist_config

# the reference's registry, in its order
ARCH_IDS = (
    "arctic_480b",
    "qwen3_moe_30b_a3b",
    "musicgen_large",
    "qwen1_5_110b",
    "deepseek_coder_33b",
    "olmo_1b",
    "qwen2_0_5b",
    "llama3_2_vision_90b",
    "recurrentgemma_9b",
    "rwkv6_3b",
    "femnist_cnn",
)


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


def olmo_1b() -> ModelConfig:
    """[arXiv:2402.00838; hf] 16L d_model=2048 16H (kv=16, MHA) d_ff=8192
    vocab=50304; non-parametric LayerNorm, tied embeddings."""
    return ModelConfig(
        name="olmo-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
        vocab_size=50304, norm="nonparam", tie_embeddings=True,
    )


def olmo_100m() -> ModelConfig:
    """~100M-parameter olmo-family model of the training example
    (``examples/train_lm.py``)."""
    return ModelConfig(
        name="olmo-100m", family="dense",
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
        d_ff=2048, vocab_size=50304, norm="nonparam", tie_embeddings=True,
        q_chunk=128, loss_chunks=1,
    )


def qwen1_5_110b() -> ModelConfig:
    """[hf:Qwen/Qwen1.5-110B family] 80L d_model=8192 64H (GQA kv=8)
    d_ff=49152 vocab=152064, QKV bias."""
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=49152,
        vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    )


def deepseek_coder_33b() -> ModelConfig:
    """[arXiv:2401.14196; hf] 62L d_model=7168 56H (GQA kv=8) d_ff=19200
    vocab=32256; llama architecture."""
    return ModelConfig(
        name="deepseek-coder-33b", family="dense",
        n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19200,
        vocab_size=32256, rope_theta=1e5,
    )


def qwen3_moe_30b_a3b() -> ModelConfig:
    """[hf:Qwen/Qwen3-30B-A3B; hf] 48L d_model=2048 32H (GQA kv=4) d_ff=768
    (per expert), vocab=151936; 128 experts top-8."""
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=768,
        vocab_size=151936, n_experts=128, top_k=8,
        rope_theta=1e6, moe_seq_chunks=8,
    )


def arctic_480b() -> ModelConfig:
    """[hf:Snowflake/snowflake-arctic-base; hf] 35L d_model=7168 56H (GQA
    kv=8) d_ff=4864 (dense residual and per-expert), vocab=32000; 128
    experts top-2 beside a parallel dense residual MLP."""
    return ModelConfig(
        name="arctic-480b", family="moe",
        n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
        vocab_size=32000, n_experts=128, top_k=2, dense_residual=True,
        moe_seq_chunks=2,
    )


def musicgen_large() -> ModelConfig:
    """[arXiv:2306.05284; hf] 48L d_model=2048 32H (kv=32, MHA) d_ff=8192
    vocab=2048, GELU MLP, LayerNorm. The EnCodec frontend is a stub: the
    inputs are precomputed frame embeddings (B, S, d_model), the targets
    codec tokens."""
    return ModelConfig(
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
        vocab_size=2048, mlp="gelu", norm="ln", frontend="frames",
    )


def llama3_2_vision_90b() -> ModelConfig:
    """[hf:meta-llama/Llama-3.2-90B-Vision; unverified] 100L d_model=8192
    64H (GQA kv=8) d_ff=28672 vocab=128256; unit = 4 self-attention + 1
    cross-attention layer. The vision frontend is a stub: precomputed patch
    embeddings (B, 1024, d_model) feed the cross-attention layers."""
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
        vocab_size=128256, rope_theta=5e5,
        block_pattern=("attn", "attn", "attn", "attn", "cross"),
        frontend="patches", n_frontend_tokens=1024, cross_attn_period=5,
    )


_REGISTRY = {"femnist_cnn": femnist_config, "recurrentgemma_9b": recurrentgemma_9b,
             "rwkv6_3b": rwkv6_3b, "qwen2_0_5b": qwen2_0_5b, "olmo_1b": olmo_1b,
             "olmo_100m": olmo_100m, "qwen1_5_110b": qwen1_5_110b,
             "deepseek_coder_33b": deepseek_coder_33b,
             "qwen3_moe_30b_a3b": qwen3_moe_30b_a3b, "arctic_480b": arctic_480b,
             "musicgen_large": musicgen_large, "llama3_2_vision_90b": llama3_2_vision_90b}
_ALIASES = {"recurrentgemma-9b": "recurrentgemma_9b", "rwkv6-3b": "rwkv6_3b",
            "qwen2-0.5b": "qwen2_0_5b", "olmo-1b": "olmo_1b",
            "qwen1.5-110b": "qwen1_5_110b", "deepseek-coder-33b": "deepseek_coder_33b",
            "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b", "arctic-480b": "arctic_480b",
            "musicgen-large": "musicgen_large", "llama-3.2-vision-90b": "llama3_2_vision_90b"}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get(name: str) -> ModelConfig:
    key = canonical(name)
    if key not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; ported: {sorted(_REGISTRY)}")
    return _REGISTRY[key]()


def get_smoke(name: str, **overrides) -> ModelConfig:
    return get(name).reduced(**overrides)


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get(a) for a in ARCH_IDS}
