"""Architecture configuration schema.

Every assigned architecture (plus the paper's own satellite/ground pair) is
expressed as an :class:`ArchConfig`.  The model builder in
``repro_torch.models.transformer`` consumes only this schema, so new
architectures are pure data.  This is the port's own copy of
``repro.configs.base``: the port imports nothing of the JAX package.

Layer heterogeneity (sliding-window vs. global attention, mLSTM vs. sLSTM,
MoE vs. dense FFN) is expressed with ``block_pattern``: a tuple of
:class:`BlockSpec` entries cycled over the depth of the network.  The stack is
executed as ``num_layers // len(block_pattern)`` iterations of a Python loop
("super blocks"), each applying the whole pattern once, with parameters
stacked along a leading ``n_super`` axis exactly as the JAX package stacks
them for its ``lax.scan``, so weights carry across without reshaping.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block specification
# ---------------------------------------------------------------------------

ATTN = "attn"          # softmax attention (GQA) + MLP/MoE
MAMBA = "mamba"        # Mamba-2 style SSD block + MLP (d_ff>0) or fused
MLSTM = "mlstm"        # xLSTM matrix-memory block (gated linear attention)
SLSTM = "slstm"        # xLSTM scalar-memory block (sequential recurrence)
HYBRID = "hybrid"      # Hymba: parallel attention + mamba heads, fused


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One position in the repeating layer pattern."""

    kind: str = ATTN               # ATTN | MAMBA | MLSTM | SLSTM | HYBRID
    window: int = 0                # 0 = global attention; >0 = sliding window
    moe: bool = False              # use MoE FFN instead of dense MLP

    def __post_init__(self):
        assert self.kind in (ATTN, MAMBA, MLSTM, SLSTM, HYBRID), self.kind


# ---------------------------------------------------------------------------
# Architecture configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | ssm | hybrid | vlm | moe | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None          # default: d_model // num_heads
    block_pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)

    # --- attention flavour ---
    rope_theta: float = 10_000.0
    use_mrope: bool = False                 # Qwen2-VL multimodal RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    qk_norm: bool = False                   # gemma3
    attn_softcap: Optional[float] = None    # gemma2: 50.0
    final_softcap: Optional[float] = None   # gemma2: 30.0

    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0                 # qwen2-moe: 4 shared experts
    moe_d_ff: int = 0                       # per-expert hidden dim
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 0.01

    # --- SSM / recurrent ---
    ssm_state: int = 0                      # mamba per-head state size
    ssm_heads: int = 0                      # 0 -> num_heads
    ssm_expand: int = 2                     # mamba inner expansion

    # --- modality frontend (stubbed; see repro_torch.models.frontends) ---
    frontend: Optional[str] = None          # None | "vision" | "audio"
    num_codebooks: int = 0                  # musicgen EnCodec codebooks
    num_patches: int = 1024                 # vision stub: patch tokens/sample

    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # long_500k eligibility (sub-quadratic / window-bounded attention)
    supports_long_context: bool = False

    # ------------------------------------------------------------------
    def __post_init__(self):
        assert self.num_layers % len(self.block_pattern) == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern period {len(self.block_pattern)}"
        )
        assert self.num_heads % max(self.num_kv_heads, 1) == 0

    # Derived quantities -------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def n_super(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def resolved_ssm_heads(self) -> int:
        return self.ssm_heads if self.ssm_heads else self.num_heads

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline term)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q = self.num_heads * hd
        n_kv = self.num_kv_heads * hd
        total = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d
        if self.num_codebooks:
            total += (self.num_codebooks - 1) * 2048 * d  # extra codebooks
        per_pattern = []
        for spec in self.block_pattern:
            p = 2 * d                                     # pre-norms
            if spec.kind in (ATTN, HYBRID):
                p += d * n_q + 2 * d * n_kv + n_q * d     # q,k,v,o
                if self.qk_norm:
                    p += 2 * hd
            if spec.kind in (MAMBA, HYBRID, MLSTM):
                e = self.ssm_expand if spec.kind != MLSTM else 2
                d_in = e * d
                heads = self.resolved_ssm_heads
                p += d * d_in * 2                         # in_proj (x,z)
                p += d * 2 * heads * max(self.ssm_state, 16)   # B,C projections
                p += d_in * d                              # out proj
                p += 2 * heads                             # dt/decay params
            if spec.kind == SLSTM:
                d_in = d
                p += 4 * d * d_in + 4 * d_in               # i,f,z,o gates
                p += d_in * d
            if spec.kind in (ATTN, HYBRID, MAMBA):
                if spec.moe:
                    e_ff = self.moe_d_ff or self.d_ff
                    p += self.moe_num_experts * 3 * d * e_ff
                    p += d * self.moe_num_experts          # router
                    if self.moe_num_shared:
                        p += 3 * d * (self.moe_num_shared * e_ff)
                elif self.d_ff > 0:
                    p += 3 * d * self.d_ff                 # swiglu
            if spec.kind in (MLSTM, SLSTM) and self.d_ff > 0:
                p += 3 * d * self.d_ff
            per_pattern.append(p)
        total += self.n_super * sum(per_pattern)
        total += d                                         # final norm
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.moe_num_experts == 0:
            return self.param_count()
        d = self.d_model
        e_ff = self.moe_d_ff or self.d_ff
        dense_experts = self.moe_num_experts - self.moe_top_k
        inactive = 0
        for spec in self.block_pattern:
            if spec.moe:
                inactive += dense_experts * 3 * d * e_ff
        return self.param_count() - self.n_super * inactive


def reduced_config(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        num_layers=len(cfg.block_pattern),
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        d_ff=128 if cfg.d_ff > 0 else 0,
        vocab_size=256,
        head_dim=16,
        moe_num_experts=min(cfg.moe_num_experts, 4),
        moe_top_k=min(cfg.moe_top_k, 2),
        moe_num_shared=min(cfg.moe_num_shared, 1),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        ssm_heads=min(cfg.ssm_heads, 4) if cfg.ssm_heads else 0,
        mrope_sections=(2, 3, 3),   # head_dim 16 → half=8

        num_patches=16,
        name=cfg.name + "-smoke",
        dtype="float32",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
