"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
GQA, no-bias, parallel attn+mlp block, tied embeddings.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22_528,
    vocab_size=256_000,
    mlp_type="swiglu",
    norm_type="layernorm",
    use_bias=False,
    parallel_block=True,
    tie_embeddings=True,
    rope_theta=8_000_000.0,
    microbatches=8,
)

SMOKE_CONFIG = CONFIG.with_(
    microbatches=1, fsdp=False,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, attn_chunk=16, loss_chunk=16,
)
