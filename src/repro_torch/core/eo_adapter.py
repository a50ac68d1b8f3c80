"""EO task adapter: wraps a backbone into the paper's LVLM task protocol.

The port of ``repro.core.eo_adapter``: inference, and the teacher-forced
training batches (``build_batch``, ``answers_from_labels``).  The satellite/GS
LVLMs answer Earth-observation prompts autoregressively over one layout:

    [ R region tokens | prompt token | answer tokens ]

- region tokens: one visual token per image region, a linear patch
  projector over the region's raw pixels (the stubbed visual encoder V);
- prompt token: the task/class id embedded with the backbone's token table
  (the text encoder E, in V's feature space as §3.2.2 requires);
- answers: VQA → 1 yes/no token; classification → 1 class token;
  detection → N_r per-region yes/no tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.data import synthetic
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EOAdapterConfig:
    grid: int = 4                       # N_r = grid² regions
    image_size: int = 64
    channels: int = 3
    num_classes: int = 8

    @property
    def n_regions(self) -> int:
        return self.grid * self.grid

    @property
    def patch_dim(self) -> int:
        side = self.image_size // self.grid
        return side * side * self.channels

    def answer_len(self, task: str) -> int:
        return self.n_regions if task == "det" else 1

    def prompt_token(self, task: str, prompts: torch.Tensor) -> torch.Tensor:
        """Disjoint prompt-id ranges per task (T_k must identify the task):
        vqa → [0, C); cls → C; det → [C+1, 2C+1)."""
        c = self.num_classes
        p = prompts.long()
        if task == "vqa":
            return p
        if task == "cls":
            return torch.full_like(p, c)
        if task == "det":
            return c + 1 + p
        raise ValueError(task)

    def prompt_id(self, task: str, prompt: int) -> int:
        """Scalar host-side ``prompt_token`` for the admission path: the
        same vocabulary layout, no device round trip."""
        c = self.num_classes
        if task == "vqa":
            return int(prompt)
        if task == "cls":
            return c
        if task == "det":
            return c + 1 + int(prompt)
        raise ValueError(task)


def init_adapter(backbone_cfg: ArchConfig, adapter_cfg: EOAdapterConfig,
                 seed: int = 0, *, device: DeviceLike = None) -> Params:
    """Random backbone + patch projector from one ``torch.Generator``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_adapter_with(backbone_cfg, adapter_cfg, gen, dev)


def init_adapter_with(backbone_cfg: ArchConfig, adapter_cfg: EOAdapterConfig,
                      gen: torch.Generator, device: torch.device) -> Params:
    """``init_adapter``'s draws from a given generator (on ``device``)."""
    w = torch.randn((adapter_cfg.patch_dim, backbone_cfg.d_model),
                    generator=gen, device=device, dtype=torch.float32)
    return {
        "backbone": T.init_params_with(backbone_cfg, gen, device),
        "patch_proj": (w * adapter_cfg.patch_dim ** -0.5).to(
            getattr(torch, backbone_cfg.dtype)),
    }


# ---------------------------------------------------------------------------
# Encoders (the paper's V and E)
# ---------------------------------------------------------------------------

def encode_regions(params: Params, adapter_cfg: EOAdapterConfig,
                   images: torch.Tensor) -> torch.Tensor:
    """V(x^r): (B, H, W, C) → (B, R, d) one visual token per region."""
    regions = synthetic.regions_of(images, adapter_cfg.grid)
    b, r = regions.shape[:2]
    flat = regions.reshape(b, r, -1).to(params["patch_proj"].dtype)
    return flat @ params["patch_proj"]


def encode_text(params: Params, backbone_cfg: ArchConfig,
                prompt_tokens: torch.Tensor) -> torch.Tensor:
    """E(T): (B,) prompt ids → (B, 1, d) text features."""
    tok = params["backbone"]["embed"]["tok"]
    return F.embedding(prompt_tokens, tok)[:, None, :]


def token_features(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Pooled embedding of generated tokens A_i: (B, L) ids → (B, d) f32."""
    tok = params["backbone"]["embed"]["tok"]
    return F.embedding(tokens, tok).float().mean(dim=1)


# ---------------------------------------------------------------------------
# Training batches
# ---------------------------------------------------------------------------

def teacher_forced(adapter_cfg: EOAdapterConfig, task: str,
                   prompts: torch.Tensor, answers: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """The text side of a training batch over [R regions | prompt |
    answers]: input ``tokens`` [prompt, ans_0 .. ans_{L-2}] (teacher
    forcing), ``targets`` with the answers at positions R .. R+L-1 and
    ``loss_mask`` 1 there, int32 / float32."""
    b, l_ans = answers.shape
    r = adapter_cfg.n_regions
    prompt = adapter_cfg.prompt_token(task, prompts)[:, None].to(torch.int32)
    tokens = torch.cat([prompt, answers[:, :-1].to(torch.int32)], dim=1)
    s_total = r + 1 + (l_ans - 1)
    targets = torch.zeros((b, s_total), dtype=torch.int32,
                          device=answers.device)
    mask = torch.zeros((b, s_total), dtype=torch.float32,
                       device=answers.device)
    targets[:, r:r + l_ans] = answers
    mask[:, r:r + l_ans] = 1.0
    return {"tokens": tokens, "targets": targets, "loss_mask": mask}


def build_batch(params: Params, backbone_cfg: ArchConfig,
                adapter_cfg: EOAdapterConfig, task: str,
                images: torch.Tensor, prompts: torch.Tensor,
                answers: torch.Tensor) -> Dict[str, torch.Tensor]:
    """answers: (B, L_ans) int32, the supervised answer tokens.  Returns
    ``T.loss_fn``'s batch: ``teacher_forced``'s tokens, targets and mask
    and the region tokens V(x) as ``patch_embeds``."""
    return dict(teacher_forced(adapter_cfg, task, prompts, answers),
                patch_embeds=encode_regions(params, adapter_cfg, images))


def answers_from_labels(adapter_cfg: EOAdapterConfig, task: str,
                        labels: torch.Tensor,
                        region_rel: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The supervised answer tokens (B, L_ans) int32: vqa the yes/no label,
    cls the class id, det the per-region relevance mask."""
    if task in ("vqa", "cls"):
        return labels[:, None].to(torch.int32)
    if task == "det":
        if region_rel is None:
            raise ValueError("det answers need region_rel")
        return region_rel.to(torch.int32)
    raise ValueError(task)


# ---------------------------------------------------------------------------
# Inference: chunked greedy generation (the progressive-confidence substrate)
# ---------------------------------------------------------------------------

def prefill_tokens(params: Params, backbone_cfg: ArchConfig,
                   adapter_cfg: EOAdapterConfig, images: torch.Tensor,
                   prompt_tokens: torch.Tensor, max_len: int
                   ) -> Tuple[torch.Tensor, Tuple, int]:
    """Prefill [regions | prompt] from already-converted prompt token ids."""
    patch_embeds = encode_regions(params, adapter_cfg, images)
    inputs = {"tokens": prompt_tokens[:, None], "patch_embeds": patch_embeds}
    return T.prefill(params["backbone"], backbone_cfg, inputs, max_len)


def prefill_regions(params: Params, backbone_cfg: ArchConfig,
                    adapter_cfg: EOAdapterConfig, images: torch.Tensor,
                    max_len: int) -> Tuple[torch.Tensor, Tuple, int]:
    """Prefill the scene prefix only: the R region tokens, no prompt.  They
    are the prompt-independent prefix of every request over one captured
    scene (causal attention), so the paged engine prefills them once per
    scene and shares their KV pages read-only."""
    patch_embeds = encode_regions(params, adapter_cfg, images)
    inputs = {"tokens": torch.zeros((images.shape[0], 0), dtype=torch.int32,
                                    device=images.device),
              "patch_embeds": patch_embeds}
    return T.prefill(params["backbone"], backbone_cfg, inputs, max_len)


def prefill_prompt(params: Params, backbone_cfg: ArchConfig,
                   adapter_cfg: EOAdapterConfig, task: str,
                   images: torch.Tensor, prompts: torch.Tensor,
                   extra_len: int) -> Tuple[torch.Tensor, Tuple, int]:
    """Prefill [regions | prompt]; cache sized for the answer."""
    return prefill_tokens(params, backbone_cfg, adapter_cfg, images,
                          adapter_cfg.prompt_token(task, prompts),
                          adapter_cfg.n_regions + 1 + extra_len)


def decode_chunk(params: Params, backbone_cfg: ArchConfig, cache: Tuple,
                 first_logits: torch.Tensor, index: int, n_tokens: int,
                 answer_vocab: int):
    """Greedy-decode ``n_tokens`` answer tokens restricted to the answer
    vocabulary.  Returns (tokens (B, n) int32, probs (B, n, V_ans), cache,
    last_logits, next_index)."""
    toks, probs = [], []
    logits = first_logits
    for _ in range(n_tokens):
        a_logits = logits[:, :answer_vocab]
        probs.append(torch.softmax(a_logits, dim=-1))
        nxt = torch.argmax(a_logits, dim=-1).to(torch.int32)
        toks.append(nxt)
        logits, cache = T.decode_step(params["backbone"], backbone_cfg, cache,
                                      {"tokens": nxt[:, None]}, index)
        index = index + 1
    return (torch.stack(toks, 1), torch.stack(probs, 1), cache, logits,
            index)


def generate(params: Params, backbone_cfg: ArchConfig,
             adapter_cfg: EOAdapterConfig, task: str, images: torch.Tensor,
             prompts: torch.Tensor, answer_vocab: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full greedy answer: returns (tokens (B, L_ans), probs (B, L_ans, V))."""
    l_ans = adapter_cfg.answer_len(task)
    logits, cache, idx = prefill_prompt(params, backbone_cfg, adapter_cfg,
                                        task, images, prompts, l_ans)
    toks, probs, *_ = decode_chunk(params, backbone_cfg, cache, logits, idx,
                                   l_ans, answer_vocab)
    return toks, probs


def prediction_from_tokens(task: str, tokens):
    """tokens (B, L_ans) → task prediction (label id or region mask)."""
    if task in ("vqa", "cls"):
        return tokens[:, 0]
    return tokens  # det: (B, R) 0/1 mask
