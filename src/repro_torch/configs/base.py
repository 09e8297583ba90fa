"""Config system: model configs, shape presets, and the architecture registry.

Every assigned architecture is a ``ModelConfig`` in its own module under
``repro_torch.configs``; ``get_config(name)`` resolves it.  Shape presets (the four
assigned input-shape cells) live here as ``ShapeConfig``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- architectural details -------------------------------------------
    mlp_type: str = "swiglu"        # swiglu | squared_relu | gelu
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    use_bias: bool = False
    parallel_block: bool = False    # command-r style parallel attn+mlp
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    use_qk_norm: bool = False
    is_encoder: bool = False        # encoder-only (no causal mask, no decode)
    input_mode: str = "tokens"      # tokens | embeddings (modality-frontend stub)

    # --- attention --------------------------------------------------------
    attn_type: str = "gqa"          # gqa | mla | none
    # MLA (deepseek-v3) parameters
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    dense_d_ff: int = 0             # deepseek: dense FFN width for first layers
    num_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # --- SSM (mamba) --------------------------------------------------------
    ssm_version: int = 0            # 0 = none, 1 = mamba1, 2 = mamba2
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0            # mamba1
    ssm_head_dim: int = 64          # mamba2
    ssm_ngroups: int = 1            # mamba2

    # --- hybrid (zamba2) ------------------------------------------------------
    hybrid_attn_every: int = 0      # apply the shared attention block every N layers

    # --- MTP (deepseek) -------------------------------------------------------
    mtp_depth: int = 0              # extra multi-token-prediction heads

    # --- execution knobs --------------------------------------------------
    dtype: str = "bfloat16"
    remat: str = "full"             # full | dots | none
    attn_chunk: int = 1024          # flash-style q/kv chunking
    loss_chunk: int = 512           # seq chunk for vocab-parallel CE
    ssm_chunk: int = 256            # chunked scan block
    microbatches: int = 1
    zero1: bool = True              # shard optimizer state over DP
    fsdp: bool = False              # shard bf16 params over DP too (ZeRO-3)
    grad_compress: bool = False     # int8 all-gather of param updates
    causal_tree_attn: bool = False  # binary-tree causal packing (perf opt)
    flash_vjp: bool = False         # custom-vjp flash attention (perf opt):
                                    # recompute probs in bwd instead of saving
                                    # S x S blocks as scan residuals
    moe_dispatch: str = "psum"      # psum | a2a (perf opt)
    explicit_tp: bool = False       # shard_map TP projections (perf opt):
                                    # forces bf16 activation all-reduces that
                                    # GSPMD otherwise runs on f32 accumulators

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_version == 2 else 0

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # parameter counting (for roofline MODEL_FLOPS = 6 N D)
    # ------------------------------------------------------------------
    def param_counts(self) -> dict:
        """Returns {'total': N, 'active': N_active} (active differs for MoE)."""
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d
        unemb = 0 if self.tie_embeddings else self.vocab_size * d
        per_layer_total = 0
        per_layer_active = 0

        def attn_params() -> int:
            if self.attn_type == "mla":
                qp = d * self.q_lora_rank + self.q_lora_rank * self.num_heads * (
                    self.qk_nope_dim + self.qk_rope_dim)
                kvp = d * (self.kv_lora_rank + self.qk_rope_dim) + self.kv_lora_rank * (
                    self.num_heads * (self.qk_nope_dim + self.v_head_dim))
                op = self.num_heads * self.v_head_dim * d
                return qp + kvp + op
            if self.attn_type == "none":
                return 0
            q = d * self.num_heads * self.head_dim
            kv = 2 * d * self.num_kv_heads * self.head_dim
            o = self.num_heads * self.head_dim * d
            return q + kv + o

        def mlp_params(ff: int) -> int:
            mults = 3 if self.mlp_type == "swiglu" else 2
            return mults * d * ff

        def ssm_params() -> int:
            di, N = self.d_inner, self.ssm_state
            if self.ssm_version == 1:
                return (d * 2 * di            # in_proj (x, z)
                        + di * self.ssm_conv  # conv
                        + di * (self.ssm_dt_rank + 2 * N)  # x_proj
                        + self.ssm_dt_rank * di + di       # dt_proj
                        + di * N + di                      # A, D
                        + di * d)                          # out_proj
            if self.ssm_version == 2:
                nh, g = self.ssm_nheads, self.ssm_ngroups
                conv_dim = di + 2 * g * N
                return (d * (2 * di + 2 * g * N + nh)  # in_proj (z,x,B,C,dt)
                        + conv_dim * self.ssm_conv
                        + 2 * nh                        # A, D
                        + di * d)                       # out_proj
            return 0

        for i in range(L):
            p = 0
            if self.family in ("ssm",):
                p += ssm_params()
            elif self.family == "hybrid":
                p += ssm_params()
            else:
                p += attn_params()
                if self.num_experts and i >= self.num_dense_layers:
                    expert = mlp_params(self.moe_d_ff)
                    p_moe = self.num_experts * expert + d * self.num_experts
                    p_shared = self.num_shared_experts * expert
                    per_layer_total += p + p_moe + p_shared
                    per_layer_active += p + self.top_k * expert + p_shared + d * self.num_experts
                    continue
                else:
                    ff = self.dense_d_ff if (self.num_experts and i < self.num_dense_layers) else self.d_ff
                    p += mlp_params(ff)
            per_layer_total += p
            per_layer_active += p

        if self.family == "hybrid" and self.hybrid_attn_every:
            # one shared attention+mlp block (counted once; active on each use)
            shared = attn_params() + mlp_params(self.d_ff)
            per_layer_total += shared
            per_layer_active += shared * (L // self.hybrid_attn_every)

        total = emb + unemb + per_layer_total
        active = emb + unemb + per_layer_active
        return {"total": total, "active": active}


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCHS = [
    "falcon_mamba_7b",
    "internvl2_1b",
    "command_r_35b",
    "nemotron_4_340b",
    "stablelm_12b",
    "starcoder2_15b",
    "qwen3_moe_30b_a3b",
    "deepseek_v3_671b",
    "zamba2_1p2b",
    "hubert_xlarge",
]


def get_config(name: str) -> ModelConfig:
    mod_name = name.replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    mod_name = name.replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE_CONFIG


def supported_cells(cfg: ModelConfig):
    """The (shape) cells this architecture supports, with skip reasons."""
    out = {}
    for s in SHAPES.values():
        if s.kind == "decode" and cfg.is_encoder:
            out[s.name] = (False, "encoder-only: no decode step")
        elif s.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
            out[s.name] = (False, "pure full-attention arch: 524k decode needs "
                                  "sub-quadratic attention (skip per brief)")
        else:
            out[s.name] = (True, "")
    return out
