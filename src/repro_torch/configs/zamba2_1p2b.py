"""zamba2-1.2b [hybrid]: 38L d_model=2048, Mamba-2 backbone (ssm_state=64) with a
shared attention(MHA 32H kv=32)+MLP(d_ff=8192) block applied periodically.
[arXiv:2411.15242; hf]

Approximation noted in DESIGN.md: the shared block is applied after every 6th
mamba layer (real Zamba2 also concatenates original embeddings and uses per-use
LoRA deltas on the shared weights; we keep a single shared block).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32_000,
    mlp_type="gelu",
    norm_type="rmsnorm",
    ssm_version=2,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    ssm_ngroups=1,
    hybrid_attn_every=6,
    microbatches=2,
    rope_theta=10_000.0,
)

SMOKE_CONFIG = CONFIG.with_(
    microbatches=1, fsdp=False,
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, ssm_state=8, ssm_head_dim=16, hybrid_attn_every=2,
    attn_chunk=16, loss_chunk=16, ssm_chunk=8,
)
