"""Gradient compression for the data-parallel all-reduce, with error
feedback (the residual of one step's compression is added back before the
next's).

The port of ``repro.train.compression``: ``topk`` keeps the k
largest-magnitude entries of each leaf, ``int8`` quantizes each leaf
symmetrically.  On one device the compress → decompress round trip runs as
it is, so the tests can hold the error-feedback invariant.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

Params = Any


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "none"          # none | topk | int8
    topk_frac: float = 0.01       # fraction of entries kept for topk
    error_feedback: bool = True


def init_error_state(params: Params) -> Params:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _topk_leaf(g: torch.Tensor, frac: float) -> torch.Tensor:
    flat = g.reshape(-1)
    k = max(int(flat.numel() * frac), 1)
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(g.abs() >= thresh, g, torch.zeros_like(g))


def _int8_leaf(g: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def compress_grads(grads: Params, err: Optional[Params],
                   cfg: CompressionConfig) -> Tuple[Params, Optional[Params]]:
    """Returns (the gradients as sent, decompressed, in their dtypes; the
    new float32 error state)."""
    if cfg.scheme == "none":
        return grads, err
    if cfg.scheme not in ("topk", "int8"):
        raise ValueError(cfg.scheme)
    if err is None:
        err = init_error_state(grads)

    def one(g, e):
        gf = g.float()
        if cfg.error_feedback:
            gf = gf + e
        sent = (_topk_leaf(gf, cfg.topk_frac) if cfg.scheme == "topk"
                else _int8_leaf(gf))
        return sent.to(g.dtype), (gf - sent if cfg.error_feedback else None)

    pairs = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(err))]
    sent, new_err = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
    return (tree_map(lambda _: next(sent), grads),
            tree_map(lambda _: next(new_err), grads))


def compressed_bytes(grads: Params, cfg: CompressionConfig) -> float:
    """Bytes that would cross the data-parallel axis a step."""
    leaves = tree_leaves(grads)
    n = sum(int(x.numel()) for x in leaves)
    if cfg.scheme == "none":
        return 2.0 * n                      # bf16
    if cfg.scheme == "int8":
        return 1.0 * n + 4.0 * len(leaves)
    if cfg.scheme == "topk":
        k = max(int(n * cfg.topk_frac), 1)
        return k * (4.0 + 4.0)              # value + index
    raise ValueError(cfg.scheme)
