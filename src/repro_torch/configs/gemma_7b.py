"""Gemma-7B — dense decoder LM with GeGLU and head_dim=256.

[arXiv:2403.08295; hf]  28L d_model=3072 16H (MHA kv=16) d_ff=24576 (GeGLU)
vocab=256000, head_dim=256, tied embeddings.
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        family="transformer",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        d_ff=24_576,
        vocab_size=256_000,
        attention="gqa",
        mlp_act="gelu",
        rope_theta=10_000.0,
        tie_embeddings=True,
        source="arXiv:2403.08295; hf",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b-reduced",
        family="transformer",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        attention="gqa",
        mlp_act="gelu",
        tie_embeddings=True,
        attn_chunk_q=32,
        attn_chunk_kv=32,
        source="reduced smoke variant",
    )


register("gemma-7b", full, reduced)
