"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000.  GQA, squared-ReLU MLP, no gated unit.  [arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18_432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73_728,
    vocab_size=256_000,
    mlp_type="squared_relu",
    norm_type="layernorm",
    use_bias=False,
    rope_theta=10_000.0,
    microbatches=16,          # 340B at GBS 256 needs deep accumulation
    fsdp=True,                # params ZeRO-3-sharded over DP too
)

SMOKE_CONFIG = CONFIG.with_(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=256, attn_chunk=16, loss_chunk=16, microbatches=1,
)
