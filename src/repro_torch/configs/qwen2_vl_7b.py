"""qwen2-vl-7b — VLM backbone with M-RoPE. [arXiv:2409.12191; hf]

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.  The vision frontend
is a STUB: ``input_specs()`` provides precomputed patch embeddings; the
backbone applies multimodal RoPE (temporal/height/width sections 16/24/24
over head_dim/2=64).

This is the paper's own ground-station model family (SpaceVerse deploys
Qwen2-VL-7B at the GS and Qwen2-VL-2B on the satellite).
"""
from repro_torch.configs.base import ArchConfig, BlockSpec, ATTN

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152_064,
    head_dim=128,
    use_mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    frontend="vision",
    num_patches=1024,
    block_pattern=(BlockSpec(kind=ATTN),),
    tie_embeddings=False,
    supports_long_context=False,  # pure full attention
)
