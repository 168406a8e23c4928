"""Llama-3.2-11B-Vision backbone — decoder LM with interleaved cross-attention.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]  40L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=128256; cross-attention image layers every 5th
layer (8 total).  The vision frontend is a STUB per the task spec:
``input_specs()`` provides precomputed patch embeddings (B, S_img, d_model).
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14_336,
        vocab_size=128_256,
        attention="gqa",
        rope_theta=500_000.0,
        cross_attn_every=5,
        num_image_tokens=4096,
        source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b-reduced",
        family="vlm",
        num_layers=5,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        attention="gqa",
        cross_attn_every=5,
        num_image_tokens=16,
        attn_chunk_q=32,
        attn_chunk_kv=32,
        source="reduced smoke variant",
    )


register("llama-3.2-vision-11b", full, reduced)
