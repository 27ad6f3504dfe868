"""phi-3-vision-4.2b [vlm]: 32L d3072 32H (kv=32) ff8192 vocab=32064 —
phi3-mini backbone + CLIP frontend STUB (input_specs provides precomputed
patch embeddings per the assignment).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32064, head_dim=96,
    rope_theta=1e4, source="hf:microsoft/Phi-3-vision-128k-instruct; hf",
    frontend=FrontendConfig(kind="vision", n_tokens=1024, d_embed=1024),
    full_attention_only=True,
)
