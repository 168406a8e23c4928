"""RecurrentGemma-9B (Griffin) — RG-LRU + local-attention hybrid, 2:1 pattern.

[arXiv:2402.19427; unverified]  38L d_model=4096 16H (MQA kv=1) d_ff=12288
(GeGLU) vocab=256000, attention window 2048, lru_width=4096, conv1d width 4.
Pattern: (recurrent, recurrent, attention) repeating; 38 = 12*(r,r,a) + (r,r).
Sub-quadratic: eligible for long_500k (O(window) attention + O(1) RG-LRU state).
"""

from repro_torch.configs.base import HybridConfig, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12_288,
        vocab_size=256_000,
        attention="gqa",
        mlp_act="gelu",
        rope_theta=10_000.0,
        tie_embeddings=True,
        hybrid=HybridConfig(
            pattern=("recurrent", "recurrent", "attention"),
            lru_width=4096,
            conv_width=4,
            attention_window=2048,
        ),
        sub_quadratic=True,
        source="arXiv:2402.19427; unverified",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-reduced",
        family="hybrid",
        num_layers=5,  # (r, r, a) + (r, r)
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        attention="gqa",
        mlp_act="gelu",
        tie_embeddings=True,
        hybrid=HybridConfig(
            pattern=("recurrent", "recurrent", "attention"),
            lru_width=64,
            conv_width=4,
            attention_window=32,
        ),
        attn_chunk_q=32,
        attn_chunk_kv=32,
        sub_quadratic=True,
        source="reduced smoke variant",
    )


register("recurrentgemma-9b", full, reduced)
