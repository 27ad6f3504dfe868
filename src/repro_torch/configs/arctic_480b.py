"""arctic-480b [moe]: 35L d7168 56H (GQA kv=8) expert_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual branch.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168, n_heads=56,
    n_kv_heads=8, d_ff=4864, vocab_size=32000, head_dim=128,
    rope_theta=1e4, source="hf:Snowflake/snowflake-arctic-base; hf",
    moe=MoEConfig(n_experts=128, top_k=2, d_expert=4864,
                  dense_residual=True),
    full_attention_only=True,
)
