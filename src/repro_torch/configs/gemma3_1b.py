"""gemma3-1b — dense, 5:1 local:global sliding-window attention.

[hf:google/gemma-3-1b-pt; unverified]  26L d_model=1152 4H (GQA kv=1)
d_ff=6912 vocab=262144, head_dim=256, qk-norm, 512-token sliding window on
local layers.  26 = 2 x period-13 pattern with 11 local + 2 global per period
(22:4 overall ~ 5:1).
The port's own copy of ``repro.configs.gemma3_1b``.
"""
from repro_torch.configs.base import ArchConfig, BlockSpec, ATTN

_L = BlockSpec(kind=ATTN, window=512)
_G = BlockSpec(kind=ATTN, window=0)

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    d_ff=6912,
    vocab_size=262_144,
    head_dim=256,
    qk_norm=True,
    rope_theta=1_000_000.0,
    block_pattern=(_L, _L, _L, _L, _L, _G, _L, _L, _L, _L, _L, _G, _L),
    tie_embeddings=True,
    supports_long_context=True,   # window-bounded local KV; global layers O(L) decode
)
