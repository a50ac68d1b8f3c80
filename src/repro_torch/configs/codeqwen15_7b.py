"""codeqwen1.5-7b — dense qwen1.5-arch. [hf:Qwen/CodeQwen1.5-7B; hf]

32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416.
The port's own copy of ``repro.configs.codeqwen15_7b``.
"""
from repro_torch.configs.base import ArchConfig, BlockSpec, ATTN

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92_416,
    head_dim=128,
    block_pattern=(BlockSpec(kind=ATTN),),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    supports_long_context=False,  # pure full attention
)
