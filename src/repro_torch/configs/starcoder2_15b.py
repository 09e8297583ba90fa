"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
GQA, RoPE, gelu MLP, bias terms.  [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24_576,
    vocab_size=49_152,
    mlp_type="gelu",
    norm_type="layernorm",
    use_bias=True,
    rope_theta=100_000.0,
    microbatches=4,
)

SMOKE_CONFIG = CONFIG.with_(
    microbatches=1, fsdp=False,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, attn_chunk=16, loss_chunk=16,
)
