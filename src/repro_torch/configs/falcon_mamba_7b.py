"""falcon-mamba-7b [ssm]: 64L d_model=4096, attention-free Mamba-1, vocab=65024,
ssm_state=16.  [arXiv:2410.05355; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65_024,
    attn_type="none",
    ssm_version=1,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_dt_rank=256,          # ceil(4096/16)
    tie_embeddings=True,      # falcon-mamba ties embeddings
    norm_type="rmsnorm",
    microbatches=4,
)

SMOKE_CONFIG = CONFIG.with_(
    microbatches=1, fsdp=False,
    num_layers=2, d_model=64, vocab_size=128, ssm_dt_rank=4, ssm_state=4,
    attn_chunk=16, loss_chunk=16, ssm_chunk=8,
)
