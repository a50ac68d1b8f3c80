"""Carry weights across from the JAX package.

The caller turns a JAX parameter tree into numpy arrays
(``jax.tree.map(np.asarray, params)``, outside this package) and
``from_numpy`` turns that into the port's tensors, leaf by leaf, keeping
the structure.  Three kinds of tree are accepted:

- adapter params ``{"backbone": ..., "patch_proj": ...}``;
- bare backbone params ``{"embed": ..., "blocks": (...), "final_norm": ...}``;
- confidence params ``{"projs": [...], "trunk": {...}}``.

``to_numpy`` is the way back; a round trip is byte-equal.  bfloat16 leaves
travel as ``ml_dtypes.bfloat16`` arrays, the type JAX hands out.

``cache_from_numpy`` carries a KV-cache tree (the JAX package's
``init_paged_cache`` leaves, quantized pools included: int8 as it is, fp8
e4m3 as ``ml_dtypes.float8_e4m3fn``, byte for byte) without the parameter
kinds' check.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map

KINDS = {
    "adapter": {"backbone", "patch_proj"},
    "backbone": {"embed", "blocks", "final_norm"},
    "confidence": {"projs", "trunk"},
}


def kind_of(tree: Any) -> str:
    keys = set(tree) if isinstance(tree, dict) else None
    for kind, want in KINDS.items():
        if keys == want:
            return kind
    raise ValueError(f"not an adapter, backbone or confidence tree: {keys}")


def _leaf_to_torch(a: np.ndarray, device: torch.device,
                   dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:       # JAX hands out read-only views
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(a)
    t = t.to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def from_numpy(tree: Any, *, device: DeviceLike = None,
               dtype: Optional[torch.dtype] = None) -> Any:
    """numpy tree (one of ``KINDS``) → tensors on ``device`` (the card
    unless ``"cpu"`` is asked for); ``dtype`` casts floating leaves."""
    kind_of(tree)
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_to_torch(np.asarray(a), dev, dtype), tree)


def cache_from_numpy(tree: Any, *, device: DeviceLike = None) -> Any:
    """numpy KV-cache tree → tensors on ``device`` (the card unless
    ``"cpu"`` is asked for), every leaf byte-equal, its dtype kept."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_to_torch(np.asarray(a), dev, None), tree)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the bf16 numpy type JAX uses; present beside JAX
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    if t.dtype == torch.float8_e4m3fn:
        import ml_dtypes
        return t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    return t.numpy()


def to_numpy(tree: Any) -> Any:
    """Tensor tree → numpy tree (the inverse of ``from_numpy``)."""
    return tree_map(_leaf_to_numpy, tree)
