"""gemma2-27b — dense, local+global alternating, logit softcap.

[arXiv:2408.00118; hf]  46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000, head_dim=128, attn softcap 50, final softcap 30, 4096 sliding
window on local (even) layers.
The port's own copy of ``repro.configs.gemma2_27b``.
"""
from repro_torch.configs.base import ArchConfig, BlockSpec, ATTN

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    d_ff=36864,
    vocab_size=256_000,
    head_dim=128,
    attn_softcap=50.0,
    final_softcap=30.0,
    block_pattern=(BlockSpec(kind=ATTN, window=4096), BlockSpec(kind=ATTN)),
    tie_embeddings=True,
    supports_long_context=True,   # 1:1 alternating SWA bounds half the KV
)
