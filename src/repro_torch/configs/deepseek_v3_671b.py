"""deepseek-v3-671b [moe]: 61L d_model=7168 128H MLA, expert d_ff=2048
vocab=129280, MoE 1 shared + 256 routed top-8, MTP.  [arXiv:2412.19437; hf]

MLA dims follow the published config: q_lora 1536, kv_lora 512, qk_nope 128,
qk_rope 64, v_head 128; first 3 layers are dense FFN (18432).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,          # MLA: heads share a latent cache; kept for bookkeeping
    head_dim=128,
    d_ff=2048,                 # routed expert width
    vocab_size=129_280,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=10_000.0,
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    num_experts=256,
    num_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    dense_d_ff=18_432,
    num_dense_layers=3,
    capacity_factor=1.25,
    mtp_depth=1,
    microbatches=8,
    fsdp=True,
)

SMOKE_CONFIG = CONFIG.with_(
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=32, vocab_size=256,
    q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    num_experts=8, top_k=2, moe_d_ff=32, dense_d_ff=64, num_dense_layers=1,
    mtp_depth=1, attn_chunk=16, loss_chunk=16, microbatches=1,
)
