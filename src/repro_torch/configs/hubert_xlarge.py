"""hubert-xlarge [audio]: 48L d_model=1280 16H MHA d_ff=5120 vocab=504 (cluster
targets).  Encoder-only; conv waveform frontend is a STUB — input_specs()
provides precomputed frame embeddings.  [arXiv:2106.07447; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    mlp_type="gelu",
    norm_type="layernorm",
    use_bias=True,
    is_encoder=True,
    input_mode="embeddings",
    microbatches=2,
)

SMOKE_CONFIG = CONFIG.with_(
    microbatches=1, fsdp=False,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=32, attn_chunk=16, loss_chunk=16,
)
