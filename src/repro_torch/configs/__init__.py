"""Configs of the port: the schema, the paper's own Qwen2-VL pair,
xlstm-125m, the hybrid hymba-1.5b and the dense attention configs
(codeqwen1.5-7b, glm4-9b, gemma2-27b, gemma3-1b).

Copies of ``repro.configs.base``, ``qwen2_vl_7b``, ``spaceverse_pair``,
``xlstm_125m``, ``hymba_1_5b``, ``codeqwen15_7b``, ``glm4_9b``,
``gemma2_27b`` and ``gemma3_1b`` (the port imports nothing of the JAX
package), with the JAX package's registry functions over the configs the
port has: ``get_config(name, reduced=False)`` and ``list_configs()``.
"""
from repro_torch.configs.base import (ArchConfig, BlockSpec, ATTN,  # noqa: F401
                                      reduced_config)
from repro_torch.configs.spaceverse_pair import (GS_CONFIG,  # noqa: F401
                                                 SAT_CONFIG, proxy_pair)
from repro_torch.configs.codeqwen15_7b import CONFIG as _codeqwen15_7b
from repro_torch.configs.gemma2_27b import CONFIG as _gemma2_27b
from repro_torch.configs.gemma3_1b import CONFIG as _gemma3_1b
from repro_torch.configs.glm4_9b import CONFIG as _glm4_9b
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba_1_5b
from repro_torch.configs.xlstm_125m import CONFIG as _xlstm_125m

_REGISTRY = {c.name: c for c in (SAT_CONFIG, GS_CONFIG, _xlstm_125m,
                                 _hymba_1_5b, _codeqwen15_7b, _glm4_9b,
                                 _gemma2_27b, _gemma3_1b)}


def list_configs():
    return sorted(_REGISTRY)


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {list_configs()}")
    cfg = _REGISTRY[name]
    return reduced_config(cfg) if reduced else cfg
