"""Llama-3.2-1B — small dense decoder LM with GQA.

[hf:meta-llama/Llama-3.2-1B; unverified]  16L d_model=2048 32H (GQA kv=8)
d_ff=8192 vocab=128256, head_dim=64, tied embeddings.
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b",
        family="transformer",
        num_layers=16,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=128_256,
        attention="gqa",
        rope_theta=500_000.0,
        tie_embeddings=True,
        source="hf:meta-llama/Llama-3.2-1B; unverified",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-reduced",
        family="transformer",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        attention="gqa",
        tie_embeddings=True,
        attn_chunk_q=32,
        attn_chunk_kv=32,
        source="reduced smoke variant",
    )


register("llama3.2-1b", full, reduced)
