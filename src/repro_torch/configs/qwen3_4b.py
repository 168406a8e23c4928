"""Qwen3-4B — dense decoder LM with per-head QK-RMSNorm and GQA.

[hf:Qwen/Qwen3-4B; hf]  36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, head_dim=128, qk_norm, tied embeddings.
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        family="transformer",
        num_layers=36,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151_936,
        attention="gqa",
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        source="hf:Qwen/Qwen3-4B; hf",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b-reduced",
        family="transformer",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        attention="gqa",
        qk_norm=True,
        tie_embeddings=True,
        attn_chunk_q=32,
        attn_chunk_kv=32,
        source="reduced smoke variant",
    )


register("qwen3-4b", full, reduced)
