"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
[hf:stabilityai/stablelm-2-1_6b family; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13_824,
    vocab_size=100_352,
    mlp_type="swiglu",
    norm_type="layernorm",
    use_bias=False,
    rope_theta=10_000.0,
    microbatches=4,
)

SMOKE_CONFIG = CONFIG.with_(
    microbatches=1, fsdp=False,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, attn_chunk=16, loss_chunk=16,
)
