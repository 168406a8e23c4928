"""DeepSeek-V2 236B — MoE decoder LM with Multi-head Latent Attention (MLA).

[arXiv:2405.04434; hf]  60L d_model=5120 128H d_ff(expert)=1536 vocab=102400,
MoE 160 routed experts top-6 + 2 shared, MLA kv_lora_rank=512.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="transformer",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,          # MLA: per-head K/V decompressed from the latent
        head_dim=128,              # qk_nope/v head dim
        d_ff=1536,                 # routed-expert intermediate (assignment value)
        vocab_size=102_400,
        attention="mla",
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        rope_theta=10_000.0,
        moe=MoEConfig(
            num_experts=160,
            top_k=6,
            expert_d_ff=1536,
            num_shared_experts=2,
            shared_d_ff=2 * 1536,
            first_dense_layers=1,
            first_dense_d_ff=12_288,
        ),
        source="arXiv:2405.04434; hf",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b-reduced",
        family="transformer",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=96,
        vocab_size=512,
        attention="mla",
        q_lora_rank=32,
        kv_lora_rank=24,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
        moe=MoEConfig(
            num_experts=8,
            top_k=2,
            expert_d_ff=96,
            num_shared_experts=2,
            shared_d_ff=192,
            first_dense_layers=1,
            first_dense_d_ff=256,
        ),
        attn_chunk_q=32,
        attn_chunk_kv=32,
        source="reduced smoke variant",
    )


register("deepseek-v2-236b", full, reduced)
