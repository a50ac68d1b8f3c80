"""glm4-9b — dense, RoPE, GQA kv=2. [hf:THUDM/glm-4-9b; hf]

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
The port's own copy of ``repro.configs.glm4_9b``.
"""
from repro_torch.configs.base import ArchConfig, BlockSpec, ATTN

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151_552,
    head_dim=128,
    block_pattern=(BlockSpec(kind=ATTN),),
    rope_theta=10_000.0,
    tie_embeddings=False,
    supports_long_context=False,  # pure full attention
)
