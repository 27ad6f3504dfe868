"""zamba2-1.2b [hybrid]: 38 Mamba2 layers d2048 + ONE shared attention
block (32H kv=32, ff8192) applied every 6 layers; ssm_state=64; vocab
32000. [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32000, head_dim=64,
    rope_theta=1e4, source="arXiv:2411.15242; hf",
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=128),
    hybrid=HybridConfig(period=6),
    full_attention_only=False,      # sub-quadratic backbone: run long_500k
)
