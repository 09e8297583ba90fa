"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) expert d_ff=768
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=768,                # == moe expert width (all layers MoE)
    vocab_size=151_936,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    use_qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    num_shared_experts=0,
    top_k=8,
    moe_d_ff=768,
    capacity_factor=1.25,
    microbatches=2,
)

SMOKE_CONFIG = CONFIG.with_(
    microbatches=1, fsdp=False,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=256, num_experts=8, top_k=2, moe_d_ff=32,
    attn_chunk=16, loss_chunk=16,
)
