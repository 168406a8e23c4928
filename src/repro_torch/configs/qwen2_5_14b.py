"""Qwen2.5-14B — dense decoder LM with GQA and QKV bias.

[hf:Qwen/Qwen2.5-14B; hf]  48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, head_dim=128, QKV bias.
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b",
        family="transformer",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=13_824,
        vocab_size=152_064,
        attention="gqa",
        qkv_bias=True,
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen2.5-14B; hf",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b-reduced",
        family="transformer",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        attention="gqa",
        qkv_bias=True,
        attn_chunk_q=32,
        attn_chunk_kv=32,
        source="reduced smoke variant",
    )


register("qwen2.5-14b", full, reduced)
