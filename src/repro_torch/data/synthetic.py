"""Procedural Earth-observation tasks with exact ground truth.

Stand-ins for the paper's RSVQA-LR / RESISC45 / DOTA-v1.0 (unavailable
offline; DESIGN.md §7).  Images are (H, W, C) float grids: a textured
background plus 0..K geometric "objects" (blobs) of distinct classes placed
at known locations — so presence-QA, scene classification and detection all
have analytic labels, and region-level relevance (which cells contain the
object) is known exactly for evaluating Eq. (3) preprocessing.

Tasks (mirroring §4.1.2):
- ``vqa``      presence question: "is there an object of class c?" → yes/no
- ``cls``      scene classification: dominant object class (45-way capped)
- ``det``      detection: which of the N_r regions contain the target class
               (evaluated with IoU over region sets)

This is the port's copy: ``EOTaskConfig``, ``_draw``, ``_region_mask`` and
``make_dataset`` are numpy only and give the same arrays as the JAX
package's from the same seed; ``regions_of``/``assemble`` work on tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EOTaskConfig:
    image_size: int = 64          # pixels per side
    grid: int = 8                 # N_r = grid*grid regions (paper: 100)
    num_classes: int = 8
    max_objects: int = 3
    object_size: int = 12
    channels: int = 3


def _draw(rng: np.random.Generator, cfg: EOTaskConfig):
    h = w = cfg.image_size
    img = rng.normal(0.0, 0.15, (h, w, cfg.channels)).astype(np.float32)
    # low-frequency background texture
    yy, xx = np.mgrid[0:h, 0:w] / h
    img += 0.2 * np.sin(2 * np.pi * (yy * rng.uniform(0.5, 2)))[..., None]
    n_obj = rng.integers(1, cfg.max_objects + 1)
    classes, boxes = [], []
    for _ in range(n_obj):
        c = int(rng.integers(0, cfg.num_classes))
        sz = cfg.object_size
        y0 = int(rng.integers(0, h - sz))
        x0 = int(rng.integers(0, w - sz))
        # class-specific pattern: oriented stripes of class-dependent period,
        # high contrast so tiny proxy models can separate the classes
        py, px = np.mgrid[0:sz, 0:sz]
        patch = 2.0 * np.sin((py * (c + 2) + px * (c % 3 + 1)) * 0.8) + 2.5
        chan = c % cfg.channels
        img[y0:y0 + sz, x0:x0 + sz, chan] += patch
        img[y0:y0 + sz, x0:x0 + sz, (chan + 1) % cfg.channels] -= 0.5 * patch
        classes.append(c)
        boxes.append((y0, x0, sz))
    return img, classes, boxes


def _region_mask(cfg: EOTaskConfig, boxes, classes, target: int) -> np.ndarray:
    """Boolean (grid*grid,) — regions overlapping any target-class object."""
    cell = cfg.image_size // cfg.grid
    mask = np.zeros((cfg.grid, cfg.grid), bool)
    for (y0, x0, sz), c in zip(boxes, classes):
        if c != target:
            continue
        r0, r1 = y0 // cell, min((y0 + sz - 1) // cell, cfg.grid - 1)
        c0, c1 = x0 // cell, min((x0 + sz - 1) // cell, cfg.grid - 1)
        mask[r0:r1 + 1, c0:c1 + 1] = True
    return mask.reshape(-1)


def make_dataset(task: str, n: int, seed: int = 0,
                 cfg: EOTaskConfig = EOTaskConfig()) -> Dict[str, np.ndarray]:
    """Returns arrays: images (N,H,W,C), prompt class ids (N,), labels, and
    region relevance masks (N, N_r)."""
    rng = np.random.default_rng(seed)
    images = np.zeros((n, cfg.image_size, cfg.image_size, cfg.channels),
                      np.float32)
    prompts = np.zeros((n,), np.int32)
    labels = np.zeros((n,), np.int32)
    region_rel = np.zeros((n, cfg.grid * cfg.grid), bool)
    for i in range(n):
        img, classes, boxes = _draw(rng, cfg)
        images[i] = img
        if task == "vqa":
            target = int(rng.integers(0, cfg.num_classes))
            prompts[i] = target
            labels[i] = int(target in classes)          # yes/no
            region_rel[i] = _region_mask(cfg, boxes, classes, target)
        elif task == "cls":
            # dominant class = class of the largest object (last drawn wins ties)
            target = classes[int(np.argmax([b[2] for b in boxes]))]
            prompts[i] = cfg.num_classes                # generic "classify" prompt
            labels[i] = target
            region_rel[i] = _region_mask(cfg, boxes, classes, target)
        elif task == "det":
            target = int(classes[rng.integers(0, len(classes))])
            prompts[i] = target
            mask = _region_mask(cfg, boxes, classes, target)
            region_rel[i] = mask
            labels[i] = int(mask.sum())                 # #relevant regions
        else:
            raise ValueError(task)
    return {"images": images, "prompts": prompts, "labels": labels,
            "region_rel": region_rel, "task": task}


def regions_of(images: torch.Tensor, grid: int) -> torch.Tensor:
    """(B, H, W, C) → (B, grid², h_r, w_r, C) region tiles (Eq. 3 N_r split)."""
    b, h, w, c = images.shape
    hr, wr = h // grid, w // grid
    x = images.reshape(b, grid, hr, grid, wr, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, grid * grid, hr, wr, c)


def assemble(regions: torch.Tensor, grid: int) -> torch.Tensor:
    """Inverse of ``regions_of``."""
    b, n_r, hr, wr, c = regions.shape
    x = regions.reshape(b, grid, grid, hr, wr, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, grid * hr, grid * wr, c)
