"""stablelm-3b [dense]: 32L d2560 32H (MHA kv=32) ff6912 vocab=50304.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=6912, vocab_size=50304, head_dim=80,
    rope_theta=1e4, source="hf:stabilityai/stablelm-2-1_6b; unverified",
    full_attention_only=True,
)
