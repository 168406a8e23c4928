"""Mamba2-370M — attention-free SSM LM using SSD (state-space duality).

[arXiv:2405.21060; unverified]  48L d_model=1024, ssm_state=128, expand=2
(d_inner=2048, head_dim=64 -> 32 ssm heads), d_conv=4, vocab=50280.
Sub-quadratic: eligible for long_500k.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        vocab_size=50_280,
        attention="none",
        tie_embeddings=True,
        ssm=SSMConfig(
            d_state=128,
            d_conv=4,
            expand=2,
            head_dim=64,
            n_groups=1,
            chunk_size=256,
        ),
        sub_quadratic=True,
        source="arXiv:2405.21060; unverified",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-reduced",
        family="ssm",
        num_layers=2,
        d_model=64,
        vocab_size=512,
        attention="none",
        tie_embeddings=True,
        ssm=SSMConfig(
            d_state=16,
            d_conv=4,
            expand=2,
            head_dim=16,
            n_groups=1,
            chunk_size=32,
        ),
        sub_quadratic=True,
        source="reduced smoke variant",
    )


register("mamba2-370m", full, reduced)
