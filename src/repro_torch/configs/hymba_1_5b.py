"""hymba-1.5b — parallel attention + mamba heads. [arXiv:2411.13676; hf]

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Every layer is a hybrid head (attention branch || mamba branch, fused by
normalised mean).  Layer 0 of each period-16 group is global attention; the
rest use a 1024-token sliding window (Hymba keeps only first/middle/last
layers global).
"""
from repro_torch.configs.base import ArchConfig, BlockSpec, HYBRID

_GLOBAL = BlockSpec(kind=HYBRID, window=0)
_LOCAL = BlockSpec(kind=HYBRID, window=1024)

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32_001,
    head_dim=64,
    ssm_state=16,
    ssm_heads=25,
    ssm_expand=2,
    block_pattern=(_GLOBAL,) + (_LOCAL,) * 15,
    tie_embeddings=True,
    supports_long_context=True,   # SSM branch O(1); attn mostly window-bounded
)
