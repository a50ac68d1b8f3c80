"""Configs of the port: the schema, the paper's own Qwen2-VL pair and
xlstm-125m.

Copies of ``repro.configs.base``, ``qwen2_vl_7b``, ``spaceverse_pair`` and
``xlstm_125m`` (the port imports nothing of the JAX package), with the JAX
package's registry functions over the configs the port has:
``get_config(name, reduced=False)`` and ``list_configs()``.
"""
from repro_torch.configs.base import (ArchConfig, BlockSpec, ATTN,  # noqa: F401
                                      reduced_config)
from repro_torch.configs.spaceverse_pair import (GS_CONFIG,  # noqa: F401
                                                 SAT_CONFIG, proxy_pair)
from repro_torch.configs.xlstm_125m import CONFIG as _xlstm_125m

_REGISTRY = {c.name: c for c in (SAT_CONFIG, GS_CONFIG, _xlstm_125m)}


def list_configs():
    return sorted(_REGISTRY)


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {list_configs()}")
    cfg = _REGISTRY[name]
    return reduced_config(cfg) if reduced else cfg
