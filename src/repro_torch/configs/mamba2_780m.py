"""mamba2-780m [ssm]: 48L d1536, attention-free SSD (state-space duality),
ssm_state=128, vocab=50280. [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab_size=50280,
    source="arXiv:2405.21060; unverified",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=128),
    full_attention_only=False,      # attention-free: run long_500k
)
