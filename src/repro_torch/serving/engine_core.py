"""EngineCore: one tier's execution substrate for Algorithm 1 (batch path).

The port of ``repro.serving.engine_core``'s batch path: ``encode`` /
``encode_cached`` / ``prefill`` / ``decode_chunk`` / ``token_features`` /
``generate``, used by the ``CascadeExecutor`` for the per-request server.
PyTorch runs eagerly, so where the JAX engine builds jitted closures the
port builds plain ones over the tier's parameters.  The slot table (paged
KV, continuous batching), speculative decoding, chunked prefill, overload
control and the device mesh are not ported yet.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import eo_adapter as EO


def shared_core(tier, adapter_cfg: EO.EOAdapterConfig) -> "EngineCore":
    """Per-tier ``EngineCore`` cache keyed by adapter-config value, living
    on the ``TierModel`` instance (as in the JAX package, where it shares
    jit caches; here it shares the encode memo)."""
    cache = getattr(tier, "_engine_cores", None)
    if cache is None:
        cache = {}
        tier._engine_cores = cache
    core = cache.get(adapter_cfg)
    if core is None:
        core = EngineCore(tier, adapter_cfg)
        cache[adapter_cfg] = core
    return core


class EngineCore:
    """Batch-path executor over one tier model."""

    def __init__(self, tier, adapter_cfg: EO.EOAdapterConfig):
        self.tier = tier
        self.ac = adapter_cfg
        params, cfg, ac = tier.params, tier.cfg, adapter_cfg
        self.device = params["patch_proj"].device

        @torch.inference_mode()
        def _encode(images, ptok):
            rf = EO.encode_regions(params, ac, images)
            tf = EO.encode_text(params, cfg, ptok)
            return rf, tf, rf.float().mean(dim=1)

        def _prefill(images, ptok, max_len):
            return EO.prefill_tokens(params, cfg, ac, images, ptok, max_len)

        def _decode_chunk(cache, logits, idx, n_tokens, answer_vocab):
            return EO.decode_chunk(params, cfg, cache, logits, idx, n_tokens,
                                   answer_vocab)

        self._encode = _encode
        self._prefill = _prefill
        self._decode_chunk = _decode_chunk
        self._token_feats = torch.inference_mode()(
            lambda toks: EO.token_features(params, toks))
        # scene-keyed encode memo for the serve path (bounded LRU)
        self._encode_cache: "OrderedDict[Any, Tuple]" = OrderedDict()
        self._encode_cache_cap = 32
        self.stats = {"encode_reuse": 0}

    # ------------------------------------------------------------------
    # batch path (shared by CascadeExecutor)
    # ------------------------------------------------------------------
    def encode(self, task: str, images: torch.Tensor, prompts: torch.Tensor):
        """V(x), E(T) and pooled visual features: (B,R,d), (B,1,d), (B,d)."""
        return self._encode(images, self.ac.prompt_token(task, prompts))

    def encode_cached(self, task: str, images: torch.Tensor,
                      prompts: torch.Tensor, scene: Optional[Any] = None,
                      prompt_id: Optional[int] = None):
        """``encode`` with a scene-keyed memo for the batch-of-one serve
        path: queries fanning out over one captured scene reuse V(x)/E(T).
        ``prompt_id`` is the host-side prompt scalar (``Request.prompt``);
        callers that have it pass it so the key never reads the device."""
        if scene is None or images.shape[0] != 1:
            return self.encode(task, images, prompts)
        if prompt_id is None:
            prompt_id = int(prompts[0])  # spacelint: disable=SL001 (cache-key fetch for callers without host prompt metadata)
        key = (scene, task, prompt_id)
        hit = self._encode_cache.get(key)
        if hit is not None:
            self._encode_cache.move_to_end(key)
            self.stats["encode_reuse"] += 1
            return hit
        out = self.encode(task, images, prompts)
        self._encode_cache[key] = out
        while len(self._encode_cache) > self._encode_cache_cap:
            self._encode_cache.popitem(last=False)
        return out

    def prefill(self, task: str, images: torch.Tensor, prompts: torch.Tensor,
                extra_len: int):
        max_len = self.ac.n_regions + 1 + extra_len
        return self._prefill(images, self.ac.prompt_token(task, prompts),
                             max_len)

    def decode_chunk(self, cache, logits, idx, n_tokens: int,
                     answer_vocab: int):
        return self._decode_chunk(cache, logits, idx, n_tokens, answer_vocab)

    def token_features(self, tokens: torch.Tensor) -> torch.Tensor:
        return self._token_feats(tokens)

    def generate(self, task: str, images: torch.Tensor, prompts: torch.Tensor,
                 answer_vocab: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full greedy answer (prefill + one chunk), as ``EO.generate``."""
        l_ans = self.ac.answer_len(task)
        logits, cache, idx = self.prefill(task, images, prompts, l_ans)
        toks, probs, *_ = self.decode_chunk(cache, logits, idx, l_ans,
                                            answer_vocab)
        return toks, probs
