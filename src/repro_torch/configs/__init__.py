"""Configs of the port: the schema and the paper's own Qwen2-VL pair.

Copies of ``repro.configs.base``, ``qwen2_vl_7b`` and ``spaceverse_pair``
(the port imports nothing of the JAX package).
"""
from repro_torch.configs.base import ArchConfig, BlockSpec, ATTN  # noqa: F401
from repro_torch.configs.spaceverse_pair import (GS_CONFIG,  # noqa: F401
                                                 SAT_CONFIG, proxy_pair)
