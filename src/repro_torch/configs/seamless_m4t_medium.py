"""SeamlessM4T-medium backbone — encoder-decoder transformer.

[arXiv:2308.11596; hf]  12L encoder + 12L decoder, d_model=1024 16H (MHA kv=16)
d_ff=4096 vocab=256206.  The audio/speech frontend is a STUB per the task spec:
``input_specs()`` provides precomputed frame embeddings (B, S, d_model).
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="encdec",
        num_layers=24,
        num_encoder_layers=12,
        num_decoder_layers=12,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=256_206,
        attention="gqa",
        mlp_act="silu",
        source="arXiv:2308.11596; hf",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium-reduced",
        family="encdec",
        num_layers=4,
        num_encoder_layers=2,
        num_decoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        attention="gqa",
        attn_chunk_q=32,
        attn_chunk_kv=32,
        source="reduced smoke variant",
    )


register("seamless-m4t-medium", full, reduced)
