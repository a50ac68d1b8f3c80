"""Decoder stack of the port: a Python loop over stacked layer parameters.

The parameter tree keeps the JAX package's structure, ``{"embed": ...,
"blocks": (per pattern position, each leaf stacked on a leading n_super
axis), "final_norm": ...}``, so the bridge converts it leaf by leaf; where
the JAX stack runs one ``lax.scan`` over super-blocks, this one indexes
layer ``i`` of each stacked leaf (a view) inside a Python loop.

Public entry points: ``init_params`` / ``init_cache`` /
``init_paged_cache``; the training forward under autograd,
``forward_train`` (logits), ``loss_fn`` (the chunked masked CE, with
block-granular remat through ``torch.utils.checkpoint``) and
``hidden_features``; under inference mode ``prefill`` (the full prompt,
filling a dense KV cache), ``decode_step`` (one token per row, dense or
through a block table over page pools), ``verify_step`` (a γ+1-token
speculative chunk) and ``prefill_chunk_step`` (the chunked prefill's
ragged fused step).  Block kinds ported: attention (``ATTN``, dense FFN),
the xLSTM mixers (``MLSTM``, ``SLSTM``, no FFN), Mamba (``MAMBA``, dense
FFN) and Hymba's hybrid (``HYBRID``: attention ‖ Mamba, dense FFN), whose
recurrent states ride the cache and are written back in place (a hybrid
layer's cache is ``{"attn": KV, "mamba": {"state"}}``); their stacks run
``prefill``, ``decode_step`` and the training forward, whose scans go
through their autograd functions (``SsmScanFn``, ``SlstmScanFn``: the
backward kernels on the card), but neither verify nor prefill-append
(they need attention blocks, as in the JAX package).  MoE blocks raise.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import (ATTN, HYBRID, MAMBA, MLSTM, SLSTM,
                                      ArchConfig, BlockSpec)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import frontends
from repro_torch.models import layers as L
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

class _Mixer(NamedTuple):
    """What a block kind runs: ``init(gen, cfg, device)`` its weights,
    ``cache(cfg, batch, kv)`` one layer's cache tree as meta tensors
    (``kv()`` is the attention KV of the dense or paged cache),
    ``apply(p, h, cfg=, spec=, cache=, mode=, **attention_args)`` the
    mixer, and whether an FFN follows it."""
    init: Callable
    cache: Callable
    apply: Callable
    ffn: bool


def _apply_attention(p, h, *, cfg, spec, cache, mode, **kw):
    return L.attention(p, h, cfg=cfg, window=spec.window, cache=cache,
                       mode=mode, **kw)[0]


def _apply_recurrent(mixer):
    def apply(p, h, *, cfg, spec, cache, mode, **_):
        return mixer(p, h, cfg=cfg, cache=cache, mode=mode)[0]
    return apply


def _apply_hybrid(p, h, *, cfg, spec, cache, mode, **kw):
    return L.hybrid(p, h, cfg=cfg, window=spec.window, cache=cache,
                    mode=mode, **kw)[0]


def _state_cache(init_cache):
    return lambda cfg, batch, kv: init_cache(cfg, batch, "meta")


_MIXERS = {
    ATTN: _Mixer(L.init_attention, lambda cfg, batch, kv: kv(),
                 _apply_attention, True),
    MLSTM: _Mixer(L.init_mlstm, _state_cache(L.init_mlstm_cache),
                  _apply_recurrent(L.mlstm), False),
    SLSTM: _Mixer(L.init_slstm, _state_cache(L.init_slstm_cache),
                  _apply_recurrent(L.slstm), False),
    MAMBA: _Mixer(L.init_mamba, _state_cache(L.init_mamba_cache),
                  _apply_recurrent(L.mamba), True),
    HYBRID: _Mixer(L.init_hybrid,
                   lambda cfg, batch, kv: L.init_hybrid_cache(cfg, batch,
                                                              kv(), "meta"),
                   _apply_hybrid, True),
}


def _check_block(spec: BlockSpec, mode: Optional[str] = None) -> None:
    if spec.kind != ATTN and mode in ("verify", "prefill_append"):
        # the JAX package's model-level backstops: a recurrent scan folds a
        # whole chunk into one state, so it neither rolls back for free
        # (verify) nor keeps chunk boundaries bit-stable (prefill_append)
        raise NotImplementedError(
            f"{mode} mode needs attention blocks, got {spec.kind!r}")
    if spec.kind not in _MIXERS or spec.moe:
        raise NotImplementedError(
            f"block kind {spec.kind!r} (moe={spec.moe}) is not ported: "
            "attention, Mamba and hybrid blocks with a dense FFN, mLSTM "
            "and sLSTM")


def _has_ffn(cfg: ArchConfig, spec: BlockSpec) -> bool:
    return _MIXERS[spec.kind].ffn and cfg.d_ff > 0


def _init_block(gen: torch.Generator, cfg: ArchConfig, spec: BlockSpec,
                device) -> Params:
    _check_block(spec)
    dt = getattr(torch, cfg.dtype)
    p: Params = {"norm1": torch.zeros((cfg.d_model,), dtype=dt,
                                      device=device),
                 "mixer": _MIXERS[spec.kind].init(gen, cfg, device)}
    if _has_ffn(cfg, spec):
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=dt, device=device)
        p["ffn"] = L.init_mlp(gen, cfg, device)
    return p


def _stacked(n: int, make: Callable[[], Params]) -> Params:
    """Stack ``n`` trees from ``make()`` on a new leading axis, filling a
    preallocated buffer one layer at a time (peak memory: the stack plus
    one layer)."""
    first = make()
    out = tree_map(lambda x: torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                                         device=x.device), first)

    def put(i, tree):
        tree_map(lambda o, x: o[i].copy_(x), out, tree)

    put(0, first)
    del first
    for i in range(1, n):
        put(i, make())
    return out


def init_params_with(cfg: ArchConfig, gen: torch.Generator,
                     device: torch.device) -> Params:
    blocks = tuple(_stacked(cfg.n_super,
                            lambda s=spec: _init_block(gen, cfg, s, device))
                   for spec in cfg.block_pattern)
    return {
        "embed": frontends.init_embed(gen, cfg, device),
        "blocks": blocks,
        "final_norm": torch.zeros((cfg.d_model,),
                                  dtype=getattr(torch, cfg.dtype),
                                  device=device),
    }


def init_params(cfg: ArchConfig, seed: int = 0, *,
                device: DeviceLike = None) -> Params:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, made
    on ``device`` (the card unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params_with(cfg, gen, dev)


def _stacked_caches(cfg: ArchConfig, kv: Callable[[], Params], batch: int,
                    device) -> Tuple:
    """Zeros of each leaf of the per-layer cache of every pattern position
    (``kv()`` for attention, as meta tensors: shapes only; the recurrent
    states with the JAX shapes; a hybrid layer's ``{"attn", "mamba"}``
    tree of both) stacked to (n_super, ...) on ``device``, one tree per
    pattern position.  Every leaf is zero, as the JAX ``init_cache`` makes
    it."""
    out = []
    for spec in cfg.block_pattern:
        _check_block(spec)
        one = _MIXERS[spec.kind].cache(cfg, batch, kv)
        out.append(tree_map(
            lambda x: torch.zeros((cfg.n_super,) + tuple(x.shape),
                                  dtype=x.dtype, device=device), one))
    return tuple(out)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device) -> Tuple:
    """Per-pattern-position caches, each leaf stacked to (n_super, ...):
    dense KV (B, max_len, KH, hd) for attention, the (B, H, dk, dk + 1)
    state for mLSTM, (h, c, n, m) of (B, d) for sLSTM, the (B, H, n, P)
    state for Mamba, and both as ``{"attn", "mamba"}`` for a hybrid."""
    dt = getattr(torch, cfg.dtype)
    return _stacked_caches(
        cfg, lambda: L.init_attn_cache(cfg, batch, max_len, dt, "meta"),
        batch, device)


def init_paged_cache(cfg: ArchConfig, batch: int, n_pages: int,
                     page_size: int, device,
                     kv_dtype: Optional[str] = None) -> Tuple:
    """Paged variant of ``init_cache``: the KV leaves become page pools
    (n_super, n_pages, page, KH, hd) shared by every sequence and addressed
    through the ``block_table`` argument of ``decode_step`` /
    ``verify_step``; recurrent states (O(1) per token, nothing to page)
    stay per slot, (n_super, batch, ...), as in the dense cache."""
    dt = getattr(torch, cfg.dtype)
    return _stacked_caches(
        cfg, lambda: L.init_paged_attn_cache(cfg, n_pages, page_size, dt,
                                             "meta", kv_dtype),
        batch, device)


def map_cache_kinds(cfg: ArchConfig, caches, *, kv, state) -> Tuple:
    """Apply ``kv`` to every attention-KV subtree and ``state`` to every
    recurrent-state subtree of one or more structurally identical caches
    (positionally, one subtree from each), as the JAX package's function of
    the same name: a hybrid layer's cache gives ``{"attn": kv(...),
    "mamba": state(...)}``."""
    out = []
    for i, spec in enumerate(cfg.block_pattern):
        _check_block(spec)
        parts = [c[i] for c in caches]
        if spec.kind == ATTN:
            out.append(kv(*parts))
        elif spec.kind == HYBRID:
            out.append({"attn": kv(*[p["attn"] for p in parts]),
                        "mamba": state(*[p["mamba"] for p in parts])})
        else:
            out.append(state(*parts))
    return tuple(out)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _apply_block(p: Params, x: torch.Tensor, *, cfg: ArchConfig,
                 spec: BlockSpec, cos, sin, cache, cache_index, mode: str,
                 block_table=None, chunk_lens=None,
                 tile_plan=None) -> torch.Tensor:
    _check_block(spec, mode)
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    h = _MIXERS[spec.kind].apply(p["mixer"], h, cfg=cfg, spec=spec,
                                 cache=cache, mode=mode, cos=cos, sin=sin,
                                 cache_index=cache_index,
                                 block_table=block_table,
                                 chunk_lens=chunk_lens, tile_plan=tile_plan)
    x = x + h
    if _has_ffn(cfg, spec):
        x = x + L.mlp(p["ffn"], L.rms_norm(x, p["norm2"], cfg.norm_eps))
    return x


def _layer(tree: Any, i: int) -> Any:
    return tree_map(lambda x: x[i], tree)


def _unstacked(tree: Any, n: int) -> list:
    """The ``n`` per-layer trees of a stacked tree, each leaf unbound once.
    Under autograd, indexing layer ``i`` of a leaf that requires grad adds
    a gradient the size of the whole stack for every layer; through one
    ``unbind`` the backward stacks the layers' gradients in one copy."""
    parts = [x.unbind(0) for x in tree_leaves(tree)]
    out = []
    for i in range(n):
        it = iter([p[i] for p in parts])
        out.append(tree_map(lambda _: next(it), tree))
    return out


#: the matmul ops a selective remat policy keeps: ``"dots"`` the products
#: without batch dims (JAX's ``dots_with_no_batch_dims_saveable``; the
#: model's ``x @ W`` runs as ``mm``), ``"dots_saveable"`` every product
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCHED_DOTS = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _selective(ops_saved):
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops_saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    def context_fn():
        return create_selective_checkpoint_contexts(policy)
    return context_fn


#: remat policies of the training forward, by the JAX package's names
#: (``repro/models/transformer.py::REMAT_POLICIES``): ``"nothing"`` keeps
#: only each block's input and recomputes the block in the backward; the
#: others keep the products named above through
#: ``create_selective_checkpoint_contexts``
REMAT_POLICIES = {
    "nothing": None,
    "dots": _selective(_DOTS),
    "dots_saveable": _selective(_DOTS + _BATCHED_DOTS),
}


def _remat(fn: Callable, policy: str, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant) with
    the named remat policy."""
    context = REMAT_POLICIES[policy]
    kw = {} if context is None else {"context_fn": context}
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def _run_stack(params: Params, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor, *, mode: str,
               cache: Optional[Tuple], cache_index=None, block_table=None,
               chunk_lens=None, tile_plan=None, remat: bool = False,
               remat_policy: str = "nothing") -> torch.Tensor:
    """The blocks in order, then the final norm.  ``cache`` None: no cache
    (mode ``"train"``).  ``remat``: each block runs under
    ``torch.utils.checkpoint`` at ``remat_policy``, so the backward
    recomputes one block at a time (the JAX package's block-granular
    ``jax.checkpoint``)."""
    cos, sin = L.rope_angles(
        positions, cfg.resolved_head_dim, cfg.rope_theta,
        cfg.mrope_sections if cfg.use_mrope and positions.dim() == 3
        else None)
    if remat and remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat_policy!r} "
                         f"({sorted(REMAT_POLICIES)})")
    per_layer = ([_unstacked(b, cfg.n_super) for b in params["blocks"]]
                 if mode == "train" else None)
    for i in range(cfg.n_super):
        for pos, spec in enumerate(cfg.block_pattern):
            p = (per_layer[pos][i] if per_layer is not None
                 else _layer(params["blocks"][pos], i))
            c = None if cache is None else _layer(cache[pos], i)

            def block(x, p=p, c=c, spec=spec):
                return _apply_block(p, x, cfg=cfg, spec=spec, cos=cos,
                                    sin=sin, cache=c,
                                    cache_index=cache_index, mode=mode,
                                    block_table=block_table,
                                    chunk_lens=chunk_lens,
                                    tile_plan=tile_plan)

            x = _remat(block, remat_policy, x) if remat else block(x)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def largest_divisor_leq(n: int, cap: int) -> int:
    """The largest divisor of ``n`` that is at most ``cap`` (at least 1)."""
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def forward_train(params: Params, cfg: ArchConfig,
                  inputs: Dict[str, torch.Tensor], *, remat: bool = True,
                  remat_policy: str = "nothing"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits under autograd.  Returns (logits (B, S, V)
    float32, aux): ``aux`` is the MoE load-balance loss, 0 for the stacks
    the port runs (no MoE blocks)."""
    x, positions = frontends.embed_inputs(params["embed"], cfg, inputs)
    x = _run_stack(params, cfg, x, positions, mode="train", cache=None,
                   remat=remat, remat_policy=remat_policy)
    return (frontends.logits_from_hidden(params["embed"], cfg, x),
            x.new_zeros((), dtype=torch.float32))


def _ce_chunk(embed: Params, cfg: ArchConfig, x: torch.Tensor,
              targets: torch.Tensor, mask: torch.Tensor):
    """One sequence chunk of the CE: (masked NLL sum, masked hit count)."""
    logits = frontends.logits_from_hidden(embed, cfg, x)       # (B, c, V)
    target_logit = logits.gather(-1, targets[..., None].long())[..., 0]
    nll = torch.logsumexp(logits, dim=-1) - target_logit
    hits = (logits.argmax(-1) == targets).float()
    return (nll * mask).sum(), (hits * mask).sum()


def loss_fn(params: Params, cfg: ArchConfig,
            batch: Dict[str, torch.Tensor], *, remat: bool = True,
            ce_chunks: int = 8, remat_policy: str = "nothing"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked next-token cross entropy + MoE aux (0 here).  ``batch``: the
    inputs and ``targets`` (B, S) int, ``loss_mask`` (B, S).  Returns
    (loss, {"ce", "aux", "acc"}), float32 scalars.

    The unembedding and CE run in ``largest_divisor_leq(S, ce_chunks)``
    sequence chunks, each rematerialised under ``remat`` (its (B, S/n, V)
    f32 logits live only inside the chunk, in the forward and again in the
    backward), with the target logit and the logsumexp per chunk: no
    (B, S, V) f32 logits are ever live, as in the JAX package."""
    x, positions = frontends.embed_inputs(params["embed"], cfg, batch)
    x = _run_stack(params, cfg, x, positions, mode="train", cache=None,
                   remat=remat, remat_policy=remat_policy)
    targets = batch["targets"]
    mask = batch["loss_mask"].float()
    s = x.shape[1]
    c = s // largest_divisor_leq(s, ce_chunks)
    ce_sum = x.new_zeros((), dtype=torch.float32)
    acc_sum = x.new_zeros((), dtype=torch.float32)
    for lo in range(0, s, c):
        args = (params["embed"], cfg, x[:, lo:lo + c],
                targets[:, lo:lo + c], mask[:, lo:lo + c])
        if remat:
            ce, hits = checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            ce, hits = _ce_chunk(*args)
        ce_sum = ce_sum + ce
        acc_sum = acc_sum + hits
    denom = torch.clamp(mask.sum(), min=1.0)
    aux = x.new_zeros((), dtype=torch.float32)
    ce = ce_sum / denom
    return ce + aux, {"ce": ce, "aux": aux, "acc": acc_sum / denom}


def hidden_features(params: Params, cfg: ArchConfig,
                    inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Final-layer hidden states (B, S, d): the paper's V(x)/E(T) feature
    space for Eq. (2) scoring and the confidence net's input."""
    x, positions = frontends.embed_inputs(params["embed"], cfg, inputs)
    return _run_stack(params, cfg, x, positions, mode="train", cache=None)


@torch.inference_mode()
def prefill(params: Params, cfg: ArchConfig, inputs: Dict[str, torch.Tensor],
            max_len: int) -> Tuple[torch.Tensor, Tuple, int]:
    """Run the full prompt, fill a cache of capacity ``max_len``.

    Returns (logits_last (B, V) float32, cache, next_index)."""
    x, positions = frontends.embed_inputs(params["embed"], cfg, inputs)
    b, s = x.shape[:2]
    cache = init_cache(cfg, b, max_len, x.device)
    x = _run_stack(params, cfg, x, positions, mode="prefill", cache=cache)
    logits = frontends.logits_from_hidden(params["embed"], cfg, x[:, -1])
    return logits, cache, s


@torch.inference_mode()
def decode_step(params: Params, cfg: ArchConfig, cache: Tuple,
                inputs: Dict[str, torch.Tensor],
                index: Union[int, torch.Tensor],
                block_table: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Tuple]:
    """One decode step at cache slot ``index``: an int for batch-uniform
    decode, or a (B,) tensor where every row sits at its own position.
    With ``block_table`` (B, P) int32 the cache is a paged one
    (``init_paged_cache``): the token's KV lands at (page, offset) through
    the table and every row reads page-indirectly.  The cache is updated in
    place.  Returns (logits (B, V) float32, cache)."""
    x, positions = frontends.embed_decode(params["embed"], cfg, inputs, index)
    x = _run_stack(params, cfg, x, positions, mode="decode", cache=cache,
                   cache_index=index, block_table=block_table)
    return frontends.logits_from_hidden(params["embed"], cfg, x[:, -1]), cache


@torch.inference_mode()
def verify_step(params: Params, cfg: ArchConfig, cache: Tuple,
                inputs: Dict[str, torch.Tensor],
                index: Union[int, torch.Tensor],
                block_table: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Tuple]:
    """Score a T = γ+1-token draft chunk in one step (the speculative
    verifier).  ``inputs`` holds (B, T) tokens whose first sits at cache
    slot ``index`` (int or (B,)); their KV is written at positions
    index..index+T-1 (through ``block_table`` when given) and attention is
    causal within the chunk.  Returns (logits (B, T, V) float32, cache):
    ``logits[:, t]`` conditions on the chunk up to ``t``.  Rolling back a
    rejected suffix is an index decrement: the next chunk overwrites it."""
    x, positions = frontends.embed_decode(params["embed"], cfg, inputs, index)
    x = _run_stack(params, cfg, x, positions, mode="verify", cache=cache,
                   cache_index=index, block_table=block_table)
    return frontends.logits_from_hidden(params["embed"], cfg, x), cache


@torch.inference_mode()
def prefill_chunk_step(params: Params, cfg: ArchConfig, cache: Tuple,
                       inputs: Dict[str, torch.Tensor], index: torch.Tensor,
                       block_table: Optional[torch.Tensor] = None,
                       chunk_lens: Optional[torch.Tensor] = None,
                       tile_plan: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Tuple]:
    """Advance each row's cache by up to C tokens in one step, the chunked
    engine's fused step.  ``inputs`` holds a (B, C) chunk per row, mixing
    modalities through ``frontends.embed_chunk`` (region rows feed
    ``patch_embeds`` where ``patch_mask``, token rows feed ``tokens``);
    ``index`` (B,) is the cache slot of each row's first chunk token;
    ``chunk_lens`` (B,) its valid-token count (rows are ragged: C-token
    region chunks, 1-token prompt/decode rows, partial chunks, idle rows
    at 0).  The valid tokens' KV lands at per-row (page, offset) through
    ``block_table`` (or densely); padding tokens write nothing that is
    read.  ``tile_plan`` (C 1, paged: a (2, n) int32
    ``kernels.paged_prefill_attention.tile_plan``) groups the rows that
    share a table row into the prefix-append kernel's row tiles; valid
    rows' results do not change with it.  The cache is updated in place.
    Returns (logits (B, V) float32 at each row's LAST valid token, through
    a (B, d) hidden gather before the unembedding, cache)."""
    x, positions = frontends.embed_chunk(params["embed"], cfg, inputs, index)
    x = _run_stack(params, cfg, x, positions, mode="prefill_append",
                   cache=cache, cache_index=index, block_table=block_table,
                   chunk_lens=chunk_lens, tile_plan=tile_plan)
    if chunk_lens is None:
        xh = x[:, -1]
    else:
        last = torch.clamp(chunk_lens.long() - 1, 0, x.shape[1] - 1)
        xh = x[torch.arange(x.shape[0], device=x.device), last]
    return frontends.logits_from_hidden(params["embed"], cfg, xh), cache
