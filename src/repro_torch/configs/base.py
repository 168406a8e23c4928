"""Config system of the LM substrate: the port's own copy of
``repro/configs/base.py``.

One ``ModelConfig`` dataclass covers every architecture family of the
reference (dense / MoE decoder LMs with GQA, MLA, qk-norm and GLU
variants, SSM, hybrid, encoder-decoder, VLM).  Architectures register
themselves into ``REGISTRY`` and are selected with ``--arch <id>``.  The
port registers every config of the reference: the dense GQA decoders
(``llama3.2-1b``, ``qwen3-4b``, ``qwen2.5-14b``, ``gemma-7b``), the MoE
``qwen2-moe-a2.7b``, the MLA + MoE ``deepseek-v2-236b``,
``mamba2-370m``, ``recurrentgemma-9b``, the encoder-decoder
``seamless-m4t-medium`` and the vision LM ``llama-3.2-vision-11b``; each
has a ``reduced()`` variant for the CPU tests.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set, identical for all 10 LM-family archs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0          # routed experts (0 => dense MLP)
    top_k: int = 0
    expert_d_ff: int = 0          # per-expert intermediate size
    num_shared_experts: int = 0   # always-on shared experts
    shared_d_ff: int = 0          # total intermediate of the shared expert(s)
    shared_gated: bool = False    # qwen2-moe gates the shared expert output
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    first_dense_layers: int = 0   # deepseek-v2: layer 0 is a dense MLP
    first_dense_d_ff: int = 0
    aux_loss_weight: float = 0.001
    dispatch_chunks: int = 1      # split token dispatch to bound the
    #                               replicated gather working set (§Perf)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256
    # derived: d_inner = expand * d_model; n_heads = d_inner // head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """recurrentgemma: repeating block pattern of recurrent + local-attn layers."""

    pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")
    lru_width: int = 0            # 0 => d_model
    conv_width: int = 4
    attention_window: int = 2048
    block_rank: int = 0           # low-rank input/gate projections (0 => full)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # "transformer" | "ssm" | "hybrid" | "encdec" | "vlm"
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    # --- attention flavour ---
    attention: str = "gqa"        # "gqa" | "mla" | "none"
    qk_norm: bool = False         # qwen3
    qkv_bias: bool = False        # qwen2.5
    mlp_act: str = "silu"         # "silu" (SwiGLU) | "gelu" (GeGLU)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # --- MLA (deepseek-v2) ---
    q_lora_rank: int = 0          # 0 => full-rank q projection
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # --- optional sub-configs ---
    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    ssm: SSMConfig = dataclasses.field(default_factory=SSMConfig)
    hybrid: HybridConfig = dataclasses.field(default_factory=HybridConfig)
    # --- encdec ---
    num_encoder_layers: int = 0
    num_decoder_layers: int = 0
    # --- vlm ---
    cross_attn_every: int = 0     # insert a cross-attn layer every N layers
    num_image_tokens: int = 0     # stub vision frontend sequence length
    # --- execution knobs (perf levers; see EXPERIMENTS §Perf) ---
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    remat_policy: str = "nothing"     # "nothing" | "dots" | "none" (no remat)
    attention_impl: str = "bands"     # "naive" | "chunked" | "bands"
    attn_chunk_q: int = 1024
    attn_chunk_kv: int = 1024
    scan_layers: bool = True
    quant: str = "none"               # "none" | "int8" (weights, serve path)
    kv_cache_dtype: str = "bfloat16"  # "bfloat16" | "int8" (decode cache)
    # --- notes ---
    source: str = ""
    sub_quadratic: bool = False   # eligible for long_500k

    # ---- derived helpers -------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks). Used for 6ND."""
        from repro_torch.models.api import analytic_param_count

        return analytic_param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models.api import analytic_param_count

        return analytic_param_count(self, active_only=True)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
REDUCED: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig],
             reduced: Callable[[], ModelConfig]) -> None:
    REGISTRY[name] = full
    REDUCED[name] = reduced


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    _ensure_imported()
    table = REDUCED if reduced else REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]()


def list_archs() -> Tuple[str, ...]:
    _ensure_imported()
    return tuple(sorted(REGISTRY))


_IMPORTED = False


def _ensure_imported() -> None:
    global _IMPORTED
    if _IMPORTED:
        return
    # import the config modules for their registration side effects: the
    # GQA decoders, dense and MoE, MLA's deepseek-v2, the ssm and hybrid
    # families, the encoder-decoder and the vision LM
    from repro_torch.configs import (  # noqa: F401
        deepseek_v2_236b,
        gemma_7b,
        llama3_2_1b,
        llama3_2_vision_11b,
        mamba2_370m,
        qwen2_5_14b,
        qwen2_moe_a2_7b,
        qwen3_4b,
        recurrentgemma_9b,
        seamless_m4t_medium,
    )

    _IMPORTED = True


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs; reason recorded in DESIGN.md §4."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: full-attention arch (no sub-quadratic path)"
    return True, ""
