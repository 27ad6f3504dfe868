"""Config system: one frozen dataclass tree describes every architecture.

Every assigned architecture is a ``ModelConfig`` instance in
``repro_torch/configs/<id>.py``; reduced smoke variants come from
``ModelConfig.smoke()``. Configs are pure data — models are built from them
by ``repro_torch.models.transformer``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio", "tnn"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # expert FFN hidden dim
    n_shared: int = 0             # always-on shared experts (deepseek)
    dense_residual: bool = False  # parallel dense FFN branch (arctic)
    #: 'catwalk' = sort/capacity top-k relocation (the paper's idea at
    #: tensor granularity); 'dense' = worst-case all-expert einsum (the
    #: "full parallel counter" baseline); 'catwalk_ep' = shard_map
    #: expert-parallel relocation with explicit psum combine (§Perf).
    dispatch: Literal["catwalk", "dense", "catwalk_ep"] = "catwalk"
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    #: keep expert F dims FSDP-sharded at rest in the EP path (arctic)
    ep_fsdp: bool = False


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (deepseek-v2)."""
    kv_lora_rank: int = 512
    d_nope: int = 128             # per-head non-rotary dim
    d_rope: int = 64              # shared rotary key dim
    d_v: int = 128                # per-head value dim


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128
    conv_kernel: int = 4

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: SSM backbone + a SHARED attention block applied every
    ``period`` layers (same parameters at every application)."""
    period: int = 6


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 12
    #: encoder frontend is a stub: input_specs provides frame embeddings
    encoder_seq: int = 1024


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB (per assignment: precomputed embeddings)."""
    kind: Literal["vision", "audio"] = "vision"
    n_tokens: int = 1024          # patches / frames
    d_embed: int = 1024           # frontend embedding dim (projected in)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: Optional[FrontendConfig] = None
    #: source attribution + verification tier, straight from the assignment
    source: str = ""
    #: True when full attention is the only sequence mixer (=> long_500k
    #: is skipped for this arch; see DESIGN.md §Arch-applicability)
    full_attention_only: bool = True
    #: remat ('none' | 'block') — activation checkpointing policy
    remat: str = "block"
    dtype: str = "bfloat16"
    #: sequence-parallel activations: constrain inter-block activations to
    #: P(dp, 'model', None) so TP all-reduces become reduce-scatter +
    #: all-gather and norms/residuals shard over sequence (§Perf)
    act_sp: bool = False
    #: batch-parallel-everywhere: shard the batch over the model axis too
    #: (ZeRO-3-style; params all-gather per use). The right regime for
    #: small SSM models where TP activation traffic dwarfs weight traffic.
    batch_over_model: bool = False

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (used for 6*N*D roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        hd = self.resolved_head_dim if self.n_heads else 0
        if self.ssm is not None and self.family in ("ssm", "hybrid"):
            di = self.ssm.d_inner(d)
            n, hds = self.ssm.d_state, self.ssm.n_heads(d)
            # in_proj (x,z,B,C,dt) + conv + out_proj
            per_layer += d * (2 * di + 2 * n + hds) + di * d
            per_layer += self.ssm.conv_kernel * (di + 2 * n)
        else:
            if self.mla is not None:
                m = self.mla
                per_layer += d * self.n_heads * (m.d_nope + m.d_rope)  # W_q
                per_layer += d * (m.kv_lora_rank + m.d_rope)           # W_dkv
                per_layer += m.kv_lora_rank * self.n_heads * (m.d_nope + m.d_v)
                per_layer += self.n_heads * m.d_v * d                  # W_o
            else:
                per_layer += d * hd * (self.n_heads + 2 * self.n_kv_heads)
                per_layer += self.n_heads * hd * d
        if self.moe is not None:
            e = self.moe
            per_layer += d * e.n_experts                                # router
            per_layer += e.n_experts * 3 * d * e.d_expert               # experts
            per_layer += e.n_shared * 3 * d * e.d_expert
            if e.dense_residual:
                per_layer += 3 * d * self.d_ff
        elif self.d_ff and self.family not in ("ssm", "hybrid"):
            per_layer += 3 * d * self.d_ff                              # SwiGLU
            # (hybrid: the shared block's MLP is counted once, below)
        total = emb + self.n_layers * per_layer
        if self.hybrid is not None:
            # one shared attention+MLP block (params used every period)
            shared = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d + 3 * d * self.d_ff
            total += shared
        if self.encdec is not None:
            # encoder layers (self-attn + FFN) + decoder cross-attn
            enc = self.encdec.n_encoder_layers * (
                d * hd * (self.n_heads + 2 * self.n_kv_heads)
                + self.n_heads * hd * d + 3 * d * self.d_ff)
            cross = self.n_layers * (
                d * hd * (self.n_heads + 2 * self.n_kv_heads)
                + self.n_heads * hd * d)
            total += enc + cross
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        inactive = self.n_layers * (e.n_experts - e.top_k) * 3 \
            * self.d_model * e.d_expert
        return self.param_count() - inactive

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        repl: dict = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads
            else self.n_kv_heads,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16,
        )
        if self.moe is not None:
            # capacity_factor 8: smoke scale is tiny, so make relocation
            # drop-free — decode==forward equivalence tests rely on it
            repl["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(2, self.moe.top_k),
                d_expert=32, capacity_factor=8.0)
        if self.mla is not None:
            repl["mla"] = MLAConfig(kv_lora_rank=32, d_nope=16, d_rope=8,
                                    d_v=16)
        if self.ssm is not None:
            repl["ssm"] = dataclasses.replace(self.ssm, d_state=16,
                                              head_dim=16, chunk=32)
        if self.hybrid is not None:
            repl["hybrid"] = HybridConfig(period=1)
        if self.encdec is not None:
            repl["encdec"] = EncDecConfig(n_encoder_layers=2, encoder_seq=16)
        if self.frontend is not None:
            repl["frontend"] = dataclasses.replace(self.frontend,
                                                   n_tokens=8, d_embed=32)
        return dataclasses.replace(self, **repl)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
