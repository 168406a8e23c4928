"""Qwen1.5/2-MoE-A2.7B — MoE decoder LM with gated shared expert.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  24L d_model=2048 16H (MHA kv=16)
d_ff(expert)=1408 vocab=151936, 60 routed experts top-4 + 4 shared
(shared intermediate 4*1408=5632, sigmoid-gated).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="transformer",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=151_936,
        attention="gqa",
        qkv_bias=True,
        rope_theta=1_000_000.0,
        moe=MoEConfig(
            num_experts=60,
            top_k=4,
            expert_d_ff=1408,
            num_shared_experts=4,
            shared_d_ff=5632,
            shared_gated=True,
        ),
        source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-reduced",
        family="transformer",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=96,
        vocab_size=512,
        attention="gqa",
        qkv_bias=True,
        moe=MoEConfig(
            num_experts=8,
            top_k=2,
            expert_d_ff=96,
            num_shared_experts=2,
            shared_d_ff=192,
            shared_gated=True,
        ),
        attn_chunk_q=32,
        attn_chunk_kv=32,
        source="reduced smoke variant",
    )


register("qwen2-moe-a2.7b", full, reduced)
