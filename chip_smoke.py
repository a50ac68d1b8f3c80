#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1, no result line) on failure:

1. Build the three CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together) into ``build/kernels/``.
2. Hold each kernel against its plain PyTorch version on the card: the main
   path's shapes in bfloat16 and small float32 shapes (head dims 12/16, GQA
   groups 1-3, ragged lengths with 0, window, softcap, q_len 3; TF32 off).
   Tolerances, element by element: attention in float32 1e-4 absolute;
   attention in bfloat16 1e-5 + 2^-6·|want| (two bfloat16 ulps of the
   plain value: both sides round an f32 result to bfloat16); region scores
   (f32 math and output in both) 1e-5 absolute, which also covers the
   Pallas kernel's rsqrt(‖x‖² + 1e-12) normalisation.  Then time kernel,
   plain version and one PyTorch library call at
   the main path's shapes (cold L2: a 64 MiB buffer is rewritten before
   every launch and its own time subtracted).
3. End to end on a small proxy pair: the port's ``CascadeServer`` on the
   card must give the decisions and tokens it gives on the CPU from the
   same weights.
4. The main path: ``CascadeServer.handle`` at the full width and depth of
   the paper's pair (Qwen2-VL-2B on the satellite, Qwen2-VL-7B on the
   ground), bfloat16, random weights from a seed, serving requests that
   reach both tiers; every kernel's launch count is zeroed before and read
   after, and each must have launched.
5. Where the time goes: prefill and per-token decode time of each tier,
   and the device's busy share over decode steps from ``torch.profiler``.

Its last lines: the card's name and power limit as ``nvidia-smi`` gives
them, one JSON object with every kernel's numbers, then
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SOURCES = ("flash_attention.cu", "decode_attention.cu", "region_score.cu")
# (absolute, relative to |want|) per element; see the docstring
TOL_F32 = (1e-4, 0.0)
TOL_BF16 = (1e-5, 2.0 ** -6)
TOL_REGION = (1e-5, 0.0)
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:84",
    "decode_attention": "src/repro/kernels/decode_attention.py:219",
    "region_score": "src/repro/kernels/region_score.py:38",
}
SOURCE_OF = {
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "region_score": "src/repro_torch/csrc/region_score.cu",
}
# full-width adapter: N_r = 32² = 1024 = cfg.num_patches, 16-px regions
# (the Eq. 3 pyramid pools by 1, 2, 4 and 8, so the side must divide by 8)
FULL_GRID, FULL_IMAGE = 32, 512


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

class ColdTimer:
    """Mean device time of ``fn`` with a cold L2: a 64 MiB buffer (more
    than the 50 MB L2) is rewritten before every launch, and the time of
    the rewrites alone is subtracted.  A spin kernel runs first so that the
    host has queued every launch before the device reaches them: the
    events then time the device, not the host's enqueue."""

    SPIN_CYCLES = 100_000_000          # ~50 ms at H100 clocks

    def __init__(self, torch, reps: int = 20):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def _loop(self, fn):
        torch = self.torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(self.SPIN_CYCLES)
        start.record()
        for _ in range(self.reps):
            self.flush.zero_()
            if fn is not None:
                fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def __call__(self, fn) -> float:
        fn()
        self.torch.cuda.synchronize()
        both = self._loop(fn)
        flush = self._loop(None)
        return max(both - flush, 0.0) / self.reps


def bound_ms(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check(name, got, want, tol, case, errors):
    """Every element within ``atol + rtol·|want|``; returns the max
    absolute error."""
    atol, rtol = tol
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = float(diff.max())
    worst = float((diff / (atol + rtol * want.abs())).max())
    ok = math.isfinite(err) and worst <= 1.0
    log(f"  {name:16s} {case:48s} max_abs_err {err:.3e} tol {atol:.0e}"
        f"+{rtol:.2g}|want| (used {worst:.3f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        errors.append(f"{name} {case}: max_abs_err {err}, {worst:.3f} of "
                      f"the tolerance")
    return err


def kernel_checks(torch):
    """Returns {kernel: measured numbers at its main-path shape}."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.region_score import region_score_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    errors, report = [], {}
    timer = ColdTimer(torch)
    bf16 = torch.bfloat16

    # -- flash attention: model layout (B, S, H, hd) through ops ------------
    log("flash_attention vs plain")
    for hd, group, kh, sq, skv, window, softcap in [
            (12, 1, 2, 40, 40, 0, None), (12, 3, 1, 33, 33, 0, None),
            (16, 2, 2, 70, 70, 0, None), (16, 3, 2, 65, 65, 16, None),
            (16, 2, 1, 37, 37, 0, 5.0), (12, 2, 2, 9, 50, 0, None)]:
        q = randn(2, sq, kh * group, hd)
        k, v = randn(2, skv, kh, hd), randn(2, skv, kh, hd)
        case = (f"f32 hd{hd} g{group} Sq{sq} Skv{skv} w{window} "
                f"cap{softcap}")
        check("flash_attention",
              ops.flash_attention(q, k, v, window=window, softcap=softcap),
              ref.flash_attention(q, k, v, window=window, softcap=softcap),
              TOL_F32, case, errors)
    for tag, h, kh in (("2B", 12, 2), ("7B", 28, 4)):
        s, hd = 1025, 128
        q, k, v = randn(1, s, h, hd, dtype=bf16), randn(1, s, kh, hd,
                                                          dtype=bf16), \
            randn(1, s, kh, hd, dtype=bf16)
        err = check("flash_attention", ops.flash_attention(q, k, v),
                    ref.flash_attention(q, k, v), TOL_BF16,
                    f"bf16 {tag} H{h} KH{kh} S{s} hd{hd}", errors)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        flops = 4.0 * hd * h * s * (s + 1) / 2
        b_ms, b_by = bound_ms(nbytes(q, k, v, q), flops, "bfloat16")
        report.setdefault("flash_attention", {})[tag] = {
            "max_abs_err": err,
            "ms": timer(lambda: flash_attention_cuda(qt, kt, vt)),
            "plain_ms": timer(lambda: ref.flash_attention(q, k, v)),
            "library_ms": timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"B1 H{h} KH{kh} Sq=Skv={s} hd{hd} bf16"}

    # -- decode attention: (B, H, hd) / (B, T, H, hd) through ops -----------
    log("decode_attention vs plain")
    for hd, group, q_len, window, softcap in [
            (12, 1, 1, 0, None), (12, 3, 1, 0, None), (16, 2, 1, 0, None),
            (16, 3, 3, 0, None), (12, 2, 3, 0, None), (16, 2, 1, 8, None),
            (16, 3, 1, 0, 3.0), (12, 2, 3, 5, 2.5)]:
        s, kh, b = 150, 2, 4
        q = randn(b, q_len, kh * group, hd)
        k, v = randn(b, s, kh, hd), randn(b, s, kh, hd)
        lens = torch.tensor([0, 1, 77, s], dtype=torch.int32, device="cuda")
        case = f"f32 hd{hd} g{group} q_len{q_len} w{window} cap{softcap}"
        if q_len == 1:
            got = ops.decode_attention(q[:, 0], k, v, lens, window=window,
                                       softcap=softcap)
            qc, kc, vc, lc = q[:, 0].cpu(), k.cpu(), v.cpu(), lens.cpu()
            want = ops.decode_attention(qc, kc, vc, lc, window=window,
                                        softcap=softcap)
        else:
            got = ops.multi_decode_attention(q, k, v, lens, window=window,
                                             softcap=softcap)
            want = ops.multi_decode_attention(q.cpu(), k.cpu(), v.cpu(),
                                              lens.cpu(), window=window,
                                              softcap=softcap)
        check("decode_attention", got.cpu(), want, TOL_F32, case, errors)
    for tag, h, kh, s in (("2B", 12, 2, 1026), ("7B", 28, 4, 2049)):
        hd = 128
        q = randn(1, h, hd, dtype=bf16)
        k, v = randn(1, s, kh, hd, dtype=bf16), randn(1, s, kh, hd,
                                                        dtype=bf16)
        err = check("decode_attention", ops.decode_attention(q, k, v, s),
                    ref.decode_attention(q, k, v, s), TOL_BF16,
                    f"bf16 {tag} H{h} KH{kh} S{s} hd{hd}", errors)
        qg = q.reshape(1, kh, h // kh, hd)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        lens = torch.full((1,), s, dtype=torch.int32, device="cuda")
        q4 = q.reshape(1, h, 1, hd)
        b_ms, b_by = bound_ms(nbytes(q, k, v, q), 4.0 * hd * h * s,
                              "bfloat16")
        report.setdefault("decode_attention", {})[tag] = {
            "max_abs_err": err,
            "ms": timer(lambda: decode_attention_cuda(qg, kt, vt, lens)),
            "plain_ms": timer(lambda: ref.decode_attention(q, k, v, lens)),
            "library_ms": timer(lambda: F.scaled_dot_product_attention(
                q4, kt, vt, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"B1 H{h} KH{kh} S{s} cache_len{s} hd{hd} bf16"}

    # -- region score --------------------------------------------------------
    log("region_score vs plain")
    for b, r, nv, ne, d in [(2, 100, 3, 2, 48), (1, 100, 1, 1, 16),
                            (2, 64, 2, 5, 300)]:
        vv, ee = randn(b, r, nv, d), randn(b, ne, d)
        check("region_score", ops.region_score(vv, ee),
              ref.region_score(vv, ee), TOL_REGION,
              f"f32 B{b} R{r} Nv{nv} Ne{ne} D{d}", errors)
    vv, ee = randn(1, 1024, 1, 1536, dtype=bf16), randn(1, 1, 1536,
                                                        dtype=bf16)
    err = check("region_score", ops.region_score(vv, ee),
                ref.region_score(vv, ee), TOL_REGION,
                "bf16 B1 R1024 Nv1 Ne1 D1536", errors)
    d = 1536
    flops = 1024 * (3 * d + 2 * d) + 3 * d
    b_ms, b_by = bound_ms(nbytes(vv, ee) + 4 * 1024, flops, "bfloat16")
    report["region_score"] = {"main": {
        "max_abs_err": err,
        "ms": timer(lambda: region_score_cuda(vv, ee)),
        "plain_ms": timer(lambda: ref.region_score(vv, ee)),
        "library_ms": timer(lambda: torch.einsum(
            "brvd,bed->br", F.normalize(vv.float(), dim=-1),
            F.normalize(ee.float(), dim=-1))),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": "B1 R1024 Nv1 Ne1 D1536 bf16"}}

    torch.cuda.synchronize()
    if errors:
        raise RuntimeError("kernel disagrees with its plain version:\n"
                           + "\n".join(errors))
    for name, shapes in report.items():
        for tag, m in shapes.items():
            log(f"  time {name:16s} {tag:4s} {m['shape']:40s} "
                f"kernel {m['ms']:.4f} ms  plain {m['plain_ms']:.4f} ms  "
                f"library {m['library_ms']:.4f} ms  bound {m['bound_ms']:.5f} "
                f"ms ({m['bound_by']})")
    return report


# ---------------------------------------------------------------------------
# phases 3-4: the request server
# ---------------------------------------------------------------------------

def make_requests(task_taus, image_size: int, grid: int, seed: int = 0):
    """(taus, Request) pairs from the numpy ``make_dataset``."""
    from repro_torch.data import synthetic
    from repro_torch.serving import Request
    cfg = synthetic.EOTaskConfig(image_size=image_size, grid=grid)
    out = []
    for i, (task, taus) in enumerate(task_taus):
        data = synthetic.make_dataset(task, 1, seed=seed + i, cfg=cfg)
        out.append((taus, Request(task=task, image=data["images"][0],
                                  prompt=int(data["prompts"][0]),
                                  t_arrival=float(i))))
    return out


def build_system(sat_cfg, gs_cfg, ac, device, seed: int = 0):
    from repro_torch.core import confidence as C
    from repro_torch.core import eo_adapter as EO
    from repro_torch.core.cascade import TierModel
    sat = TierModel(EO.init_adapter(sat_cfg, ac, seed, device=device),
                    sat_cfg)
    gs = TierModel(EO.init_adapter(gs_cfg, ac, seed + 1, device=device),
                   gs_cfg)
    conf = C.init_confidence(sat_cfg.d_model, sat_cfg.d_model, hidden=64,
                             num_stages=2, seed=seed + 2, device=device)
    return sat, gs, conf


def serve(torch, sat, gs, conf, ac, requests, device, answer_vocab):
    """Serve ``requests`` through ``CascadeServer.handle``; one server per
    tau setting.  Returns [(taus, request, response, seconds)]."""
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.network.orbit import ContactPlan
    from repro_torch.serving import CascadeServer
    servers, out = {}, []
    for taus, req in requests:
        if taus not in servers:
            servers[taus] = CascadeServer(
                sat, gs, ac, conf,
                CascadeConfig(taus=taus, answer_vocab=answer_vocab),
                plan=ContactPlan(contact_fraction_override=1.0),
                device=device)
        t0 = time.perf_counter()
        resp = servers[taus].handle(req, now=req.t_arrival)
        if device != "cpu":
            torch.cuda.synchronize()
        out.append((taus, req, resp, time.perf_counter() - t0))
    return out


def check_response(req, resp, ac, answer_vocab):
    toks = resp.tokens.reshape(-1)
    if len(toks) != ac.answer_len(req.task):
        raise RuntimeError(f"{req.task}: {len(toks)} answer tokens")
    if toks.min() < 0 or toks.max() >= answer_vocab:
        raise RuntimeError(f"{req.task}: token outside the answer vocab")
    if not (math.isfinite(resp.latency_s) and resp.latency_s > 0):
        raise RuntimeError(f"{req.task}: latency {resp.latency_s}")
    if (resp.tier == "ground") != (resp.tx_bytes > 0):
        raise RuntimeError(f"{req.task}: tier {resp.tier} with "
                           f"{resp.tx_bytes} bytes")


SMALL_TASKS = [("vqa", (0.5, 0.4)), ("cls", (0.5, 0.4)),
               ("det", (0.0, 1.01)), ("vqa", (0.0, 1.01)),
               ("cls", (0.0, 0.0)), ("vqa", (1.01, 0.0))]


def small_reference(torch):
    """The proxy pair on the card against the same weights on the CPU."""
    from repro_torch.configs.spaceverse_pair import proxy_pair
    from repro_torch.core import eo_adapter as EO
    from repro_torch.core.cascade import TierModel
    from repro_torch.tree import tree_map
    sat_cfg, gs_cfg = proxy_pair("small")
    ac = EO.EOAdapterConfig()
    sat, gs, conf = build_system(sat_cfg, gs_cfg, ac, "cpu", seed=5)

    def to_card(tree):
        return tree_map(lambda t: t.to("cuda"), tree)

    card = (TierModel(to_card(sat.params), sat_cfg),
            TierModel(to_card(gs.params), gs_cfg), to_card(conf))
    reqs = make_requests(SMALL_TASKS, ac.image_size, ac.grid, seed=50)
    want = serve(torch, sat, gs, conf, ac, reqs, "cpu", 9)
    got = serve(torch, *card, ac, reqs, "cuda", 9)
    for (taus, req, w, _), (_, _, g, _) in zip(want, got):
        check_response(req, g, ac, 9)
        same = (g.tier == w.tier and g.exit_stage == w.exit_stage
                and (g.tokens == w.tokens).all()
                and math.isclose(g.tx_bytes, w.tx_bytes, rel_tol=1e-6))
        log(f"  small {req.task:3s} taus {taus}: card {g.tier}/"
            f"{g.exit_stage} cpu {w.tier}/{w.exit_stage} "
            f"{'equal' if same else 'DIFFERENT'}")
        if not same:
            raise RuntimeError(f"card and CPU disagree on {req.task} {taus}")
    return {(w.tier, w.exit_stage) for _, _, w, _ in want}


MAIN_TASKS = [("vqa", (0.5, 0.4)), ("cls", (0.5, 0.4)),
              ("vqa", (0.0, 1.01)), ("cls", (0.0, 0.0)),
              ("vqa", (1.01, 0.0)), ("det", (1.01, 0.0))]


def main_path(torch):
    from repro_torch.configs.spaceverse_pair import GS_CONFIG, SAT_CONFIG
    from repro_torch.core import eo_adapter as EO
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves
    ac = EO.EOAdapterConfig(grid=FULL_GRID, image_size=FULL_IMAGE)
    assert ac.n_regions == SAT_CONFIG.num_patches == GS_CONFIG.num_patches
    t0 = time.perf_counter()
    sat, gs, conf = build_system(SAT_CONFIG, GS_CONFIG, ac, "cuda")
    torch.cuda.synchronize()
    n_sat = sum(t.numel() for t in tree_leaves(sat.params))
    n_gs = sum(t.numel() for t in tree_leaves(gs.params))
    log(f"init {SAT_CONFIG.name} {n_sat / 1e9:.3f} B params, "
        f"{GS_CONFIG.name} {n_gs / 1e9:.3f} B params, bf16, "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    reqs = make_requests(MAIN_TASKS, FULL_IMAGE, FULL_GRID, seed=100)
    answer_vocab = ac.num_classes + 1

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    results = serve(torch, sat, gs, conf, ac, reqs, "cuda", answer_vocab)
    torch.cuda.synchronize()
    counts = ops.launch_counts()

    for taus, req, resp, sec in results:
        check_response(req, resp, ac, answer_vocab)
        log(f"  main {req.task:3s} taus {taus}: tier {resp.tier:9s} "
            f"exit {resp.exit_stage:2d} tokens {len(resp.tokens.reshape(-1))}"
            f" tx_bytes {resp.tx_bytes:.0f} wall {sec:.3f} s")
    tiers = {resp.tier for _, _, resp, _ in results}
    if tiers != {"satellite", "ground"}:
        raise RuntimeError(f"main path reached only {tiers}")
    log(f"  launches in the main path: {counts}")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: "
                           f"{missing}")
    return sat, gs, ac, counts, results


def breakdown(torch, sat, gs, ac, n_steps: int = 32):
    """Prefill and per-token decode time of each tier (host clock around
    synchronised work) and the device's busy share over decode steps."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import eo_adapter as EO
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    rng = torch.Generator(device="cuda").manual_seed(7)
    images = torch.rand((1, ac.image_size, ac.image_size, 3), generator=rng,
                        device="cuda")
    prompts = torch.tensor([3], dtype=torch.int32, device="cuda")
    out = {}
    for name, tier in (("sat", sat), ("gs", gs)):
        ptok = ac.prompt_token("vqa", prompts)
        EO.prefill_tokens(tier.params, tier.cfg, ac, images, ptok, 1100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, idx = EO.prefill_tokens(tier.params, tier.cfg, ac,
                                               images, ptok, 1100)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        tok = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
        t0 = time.perf_counter()
        for i in range(n_steps):
            logits, cache = T.decode_step(tier.params["backbone"], tier.cfg,
                                          cache, {"tokens": tok}, idx + i)
        torch.cuda.synchronize()
        t_step = (time.perf_counter() - t0) / n_steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(8):
                logits, cache = T.decode_step(tier.params["backbone"],
                                              tier.cfg, cache,
                                              {"tokens": tok},
                                              idx + n_steps + i)
            torch.cuda.synchronize()
        events = prof.key_averages()

        def dev_us(e):   # the attribute's name differs across versions
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))

        # Only the device's own events (kernels, copies): a CPU op such as
        # aten::mm also carries its kernels' time as self device time, so
        # summing every event would count that work twice.
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        dev_us_total = sum(dev_us(e) for e in kernels)
        top_dev = sorted(kernels, key=lambda e: -dev_us(e))[:6]
        top_host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:6]
        # a decode step streams every layer's weights and the unembedding
        bb = tier.params["backbone"]
        head = bb["embed"].get("head", bb["embed"]["tok"])
        step_bytes = nbytes(*tree_leaves(bb["blocks"]), head)
        out[name] = {
            "prefill_ms": 1e3 * t_prefill,
            "decode_step_ms": 1e3 * t_step,
            "decode_bound_ms": 1e3 * step_bytes / HBM_BYTES_PER_S,
            "device_busy_share": dev_us_total / 1e3 / (8 * 1e3 * t_step),
            "top_device_ms_per_step": {e.key[:60]: dev_us(e) / 8e3
                                       for e in top_dev},
            "top_host_ms_per_step": {e.key[:60]: e.self_cpu_time_total / 8e3
                                     for e in top_host}}
        log(f"  {name}: prefill {out[name]['prefill_ms']:.2f} ms, decode "
            f"step {out[name]['decode_step_ms']:.3f} ms (weight-streaming "
            f"bound {out[name]['decode_bound_ms']:.3f} ms), device busy "
            f"{out[name]['device_busy_share']:.3f}")
    log("breakdown " + json.dumps(out))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's smoke run needs the card")
        return 1
    import numpy as np  # noqa: F401  (the port's data path needs numpy)
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("phase 1: build")
    t0 = time.perf_counter()
    rep = build.build_all(SOURCES)
    for src, r in rep.items():
        info = [ln.strip() for ln in r["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"  {src}: {r['path']} ({r['seconds']:.1f} s)")
        for ln in info:
            log(f"    {ln}")
    log(f"  built in {time.perf_counter() - t0:.1f} s")

    log("phase 2: kernels vs plain")
    kernels = kernel_checks(torch)

    log("phase 3: small proxy pair, card vs CPU")
    small_reference(torch)

    log("phase 4: main path at full width")
    sat, gs, ac, counts, _ = main_path(torch)

    log("phase 5: where the time goes")
    breakdown(torch, sat, gs, ac)

    line = []
    for name in ("flash_attention", "decode_attention", "region_score"):
        shapes = kernels[name]
        m = shapes.get("7B", shapes.get("main"))
        line.append({
            "name": name, "route": "cuda", "source": SOURCE_OF[name],
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "shape": m["shape"],
            "by_shape": shapes})
    log(smi)
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
