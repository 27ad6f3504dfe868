"""seamless-m4t-medium [audio]: enc-dec, 12L d1024 16H ff4096
vocab=256206 — multimodal; audio frontend STUB (precomputed frame
embeddings). [arXiv:2308.11596; hf]"""
from repro_torch.configs.base import EncDecConfig, FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio", n_layers=12, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=256206, head_dim=64,
    rope_theta=1e4, source="arXiv:2308.11596; hf",
    encdec=EncDecConfig(n_encoder_layers=12, encoder_seq=1024),
    frontend=FrontendConfig(kind="audio", n_tokens=1024, d_embed=1024),
    full_attention_only=True,
)
