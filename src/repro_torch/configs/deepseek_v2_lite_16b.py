"""deepseek-v2-lite-16b [moe]: 27L d2048 16H, MLA kv_lora=512,
expert_ff=1408, vocab=102400, 2 shared + 64 routed experts top-6.
[arXiv:2405.04434; hf]
Deviation noted in DESIGN.md: the real model's first layer uses a dense
FFN; we keep all layers MoE for scan-over-layers homogeneity."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=102400, head_dim=128,
    rope_theta=1e4, source="arXiv:2405.04434; hf",
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
    mla=MLAConfig(kv_lora_rank=512, d_nope=128, d_rope=64, d_v=128),
    full_attention_only=True,
)
