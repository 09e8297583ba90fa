"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
InternViT frontend is a STUB — input_specs() provides precomputed patch embeddings
interleaved with token embeddings.  [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_655,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    use_bias=True,            # Qwen2 backbone uses qkv bias
    rope_theta=1_000_000.0,
    input_mode="embeddings",  # modality frontend stub
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.with_(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, attn_chunk=16, loss_chunk=16,
)
