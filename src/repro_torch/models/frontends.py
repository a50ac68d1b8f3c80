"""Embedding, the vision splice with M-RoPE positions, and unembedding.

The port of ``repro.models.frontends`` for the text and vision frontends
(the stubbed patch embeddings of a VLM spliced before the text tokens).
The audio/codebook frontend is not ported yet and raises.

Positions follow the JAX package's formulas exactly: prefill gives the
``n_patch`` patches (0, p // side, p % side) with ``side`` from the REAL
patch count, and text continues diagonally from ``side``; decode places
token positions with ``side`` and the offset from ``cfg.num_patches``.  The
two layouts agree only when the number of regions equals
``cfg.num_patches``.  ``embed_chunk`` mixes both per row for the chunked
prefill's fused step.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

Params = Dict[str, Any]


def init_embed(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    if cfg.num_codebooks:
        raise NotImplementedError("codebook (audio) embeddings are not ported")
    dt = getattr(torch, cfg.dtype)
    scale = cfg.d_model ** -0.5

    def table(shape):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (w * scale).to(dt)

    p = {"tok": table((cfg.vocab_size, cfg.d_model))}
    if not cfg.tie_embeddings:
        p["head"] = table((cfg.d_model, cfg.vocab_size))
    return p


def _check_frontend(cfg: ArchConfig) -> None:
    if cfg.frontend not in (None, "vision"):
        raise NotImplementedError(f"frontend {cfg.frontend!r} is not ported")


def _mrope_positions(cfg: ArchConfig, n_patch: int, s_text: int, batch: int,
                     device) -> torch.Tensor:
    side = max(int(math.isqrt(max(n_patch, 1))), 1)
    pi = torch.arange(n_patch, device=device)
    patch = torch.stack([torch.zeros_like(pi), pi // side, pi % side])
    ti = side + torch.arange(s_text, device=device)
    text = torch.stack([ti, ti, ti])
    pos = torch.cat([patch, text], dim=1)                     # (3, S)
    return pos[:, None].expand(3, batch, n_patch + s_text)


def embed_inputs(p: Params, cfg: ArchConfig, inputs: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence embedding (prefill).  Returns (x (B, S, d), positions
    (B, S), or (3, B, S) for M-RoPE)."""
    _check_frontend(cfg)
    tokens = inputs["tokens"]
    x = F.embedding(tokens, p["tok"])
    b = tokens.shape[0]
    if cfg.frontend == "vision":
        patches = inputs["patch_embeds"]                      # (B, Np, d)
        n_patch, s_text = patches.shape[1], tokens.shape[1]
        x = torch.cat([patches.to(x.dtype), x], dim=1)
        if cfg.use_mrope:
            return x, _mrope_positions(cfg, n_patch, s_text, b, x.device)
    s = x.shape[1]
    return x, torch.arange(s, device=x.device)[None].expand(b, s)


def embed_decode(p: Params, cfg: ArchConfig, inputs: Dict[str, torch.Tensor],
                 index: Union[int, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embedding for a (B, T) decode chunk whose first token sits at
    cache slot ``index`` (an int, or (B,) per-row slots)."""
    _check_frontend(cfg)
    tokens = inputs["tokens"]                                  # (B, T)
    b, t = tokens.shape
    x = F.embedding(tokens, p["tok"])
    steps = torch.arange(t, device=x.device)
    if isinstance(index, int) or index.dim() == 0:
        pos = (index + steps)[None].expand(b, t)
    else:
        pos = index[:, None] + steps
    if cfg.frontend == "vision" and cfg.use_mrope:
        side = max(int(math.isqrt(max(cfg.num_patches, 1))), 1)
        return x, (side + (pos - cfg.num_patches))[None].expand(3, b, t)
    return x, pos


def embed_chunk(p: Params, cfg: ArchConfig, inputs: Dict[str, torch.Tensor],
                index: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixed-modality (B, C) chunk embedding for the fused chunked-prefill
    step.  Each row is a region chunk (``inputs["patch_embeds"]`` (B, C, d),
    selected per row by ``inputs["patch_mask"]`` (B,) bool) or a token chunk
    (``inputs["tokens"]`` (B, C)); ``index`` (B,) is the cache slot of each
    row's first chunk token.  Positions follow ``embed_inputs``: region
    token at slot ``p`` is patch ``p``, M-RoPE ``(0, p // side, p % side)``;
    token rows continue diagonally at ``side + p - num_patches``."""
    _check_frontend(cfg)
    tokens = inputs["tokens"]
    b, t = tokens.shape
    x = F.embedding(tokens, p["tok"])
    patches = inputs.get("patch_embeds")
    patch_mask = inputs.get("patch_mask")
    if patches is not None:
        x = torch.where(patch_mask[:, None, None], patches.to(x.dtype), x)
    index = torch.as_tensor(index, device=x.device)
    per_row = index[:, None] if index.dim() == 1 else index
    pos = (per_row + torch.arange(t, device=x.device)).expand(b, t)
    if cfg.frontend == "vision" and cfg.use_mrope:
        side = max(int(math.isqrt(max(cfg.num_patches, 1))), 1)
        tpos = (side + (pos - cfg.num_patches))[None].expand(3, b, t)
        if patches is None:
            return x, tpos
        ppos = torch.stack([torch.zeros_like(pos), pos // side, pos % side])
        return x, torch.where(patch_mask[None, :, None], ppos, tpos)
    return x, pos


def logits_from_hidden(p: Params, cfg: ArchConfig, x: torch.Tensor
                       ) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ p["tok"].T
    else:
        logits = x @ p["head"]
    logits = logits.float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits
