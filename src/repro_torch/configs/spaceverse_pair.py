"""The paper's own satellite/ground model pair (Qwen2-VL family).

SpaceVerse deploys Qwen2-VL-2B on the satellite (W^s) and Qwen2-VL-7B at the
ground station (W^g).  ``SAT_CONFIG`` mirrors the 2B architecture
[arXiv:2409.12191]; ``GS_CONFIG`` aliases the assigned qwen2-vl-7b config.

``proxy_pair()`` returns trainable laptop-scale stand-ins with the same
capacity ordering (|W^g| > |W^s|), used by the end-to-end example that trains
both tiers on synthetic Earth-observation tasks.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, BlockSpec, ATTN
from repro_torch.configs.qwen2_vl_7b import CONFIG as GS_CONFIG  # noqa: F401

SAT_CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    head_dim=128,
    use_mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    frontend="vision",
    num_patches=1024,
    block_pattern=(BlockSpec(kind=ATTN),),
    tie_embeddings=True,
    supports_long_context=False,
)


def proxy_pair(scale: str = "small"):
    """(W^s, W^g) proxies for end-to-end CPU training.

    ``small``  : ~2M / ~14M params — test-suite scale.
    ``example``: ~12M / ~110M params — examples/train_eo_lvlm.py scale.
    """
    if scale == "small":
        # capacity gap mirrors the paper's 2B-vs-7B split: the satellite tier
        # is deliberately small enough that hard samples exceed it
        sat_kw = dict(num_layers=1, d_model=48, num_heads=4, num_kv_heads=2,
                      d_ff=96, head_dim=12, mrope_sections=(2, 2, 2))
        gs_kw = dict(num_layers=4, d_model=128, num_heads=8, num_kv_heads=2,
                     d_ff=256, head_dim=16, mrope_sections=(2, 3, 3))
    elif scale == "example":
        sat_kw = dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
                      d_ff=768, head_dim=64, mrope_sections=(8, 12, 12))
        gs_kw = dict(num_layers=8, d_model=768, num_heads=12, num_kv_heads=4,
                     d_ff=2048, head_dim=64, mrope_sections=(8, 12, 12))
    else:
        raise ValueError(scale)
    common = dict(vocab_size=512, num_patches=16, dtype="float32",
                  tie_embeddings=True)
    sat = dataclasses.replace(SAT_CONFIG, name=f"proxy-sat-{scale}",
                              **common, **sat_kw)
    gs = dataclasses.replace(SAT_CONFIG, name=f"proxy-gs-{scale}",
                             **common, **gs_kw)
    return sat, gs
