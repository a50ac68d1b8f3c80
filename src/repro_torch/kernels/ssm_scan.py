"""Chunked gated linear-attention scan: the wrapper around ``csrc/ssm_scan.cu``
and ``csrc/ssm_scan_mma.cu``.

S_t = exp(g_t)·S_{t-1} + k_t v_tᵀ, o_t = S_tᵀ q_t, in chunks of ``chunk``
tokens from an initial (dk, dv) f32 state; the exponent is masked before
``exp`` (as ``ref.ssm_scan``).  Layout (B, H, S, d) as the Pallas kernel's,
any strides with a unit innermost one, so ``ops`` hands the model's
(B, S, H, d) tensors over as transposed views without a copy.

Two routes, chosen by ``route`` from the dtype and dk:

* ``"mma"`` (bf16, dk % 16 == 0, dk <= 384: the xlstm-125m prefill): one
  thread-block cluster per (batch row, head), its blocks splitting dv in
  16-column m-tiles and keeping their slice of the state in registers
  across the chunks; q·kᵀ once per chunk, shared through distributed
  shared memory; every product on the tensor cores (``mma.sync``), the
  f32 operands as bf16 hi + lo pairs.  ``cluster_plan`` picks the
  cluster size on the card's cluster occupancy.  q and k need 16-byte
  aligned bases and strides (TMA); v and o take any strides.
* ``"cuda_cores"`` (f32, and every other dk): the first port, f32 math on
  CUDA cores, dv in 32-column tiles, q·kᵀ recomputed in each.

Both raise on what they do not take; neither falls back to the other.
The ragged last column tile (xLSTM's dv = dk + 1 = 385) is masked element
by element on both: no padding copy.

The backward (training) is one C entry, ``csrc/ssm_scan_bwd.cu`` (f32
math on the CUDA cores, f32 and bf16 operands, dk <= ``BWD_MAX_DK``), four
launches: the intra-chunk terms, every chunk at once; per (batch row,
head, 32 value columns) a forward sweep that recomputes the chunk-start
states into scratch, then the chunks in reverse carrying the state
gradient; dq and dk summed over the intra term and the column slices in a
fixed order; dlog_g's reverse cumulative sum.
``SsmScanFn`` ties forward and backward together for autograd: on the
card the forward is ``ssm_scan_cuda`` and the backward
``ssm_scan_bwd_cuda``; on the CPU both are the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import (DTYPES, CudaKernel, check_16_bytes,
                                       check_operands)
from repro_torch.kernels.ref import chunk_for

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("ssm_scan.cu", "ssm_scan_fwd",
                    [_P] * 7 + [_I] * 6 + [_L] * 15 + [_I, _P])
MMA_KERNEL = CudaKernel("ssm_scan_mma.cu", "ssm_scan_mma_fwd",
                        [_P] * 7 + [_I] * 7 + [_L] * 15 + [_P])
BWD_KERNEL = CudaKernel("ssm_scan_bwd.cu", "ssm_scan_bwd",
                        [_P] * 20 + [_I] * 6 + [_L] * 27 + [_I, _P])
MAX_CHUNK = 64
MAX_DK = 1024      # the (dk, 32) f32 state slice must fit shared memory
MMA_MAX_DK = 384   # the tensor-core route: a warp's half of the state's
#                    dk (96 floats a thread) and q, k in shared memory
MMA_COLS = 16      # value columns of an m-tile
MMA_MAX_TILES = 5  # m-tiles a block owns (two warps each, 10 warps)
MAX_CLUSTER = 16   # blocks a cluster (more than 8 is non-portable)
BWD_MAX_DK = 512   # the backward's (dk, 32) slice of dS in shared memory
BWD_COLS = 32      # value columns a block of the backward


def route(dtype: torch.dtype, dk: int) -> str:
    """The kernel a scan takes: ``"mma"`` for bf16 with dk % 16 == 0 and dk
    <= ``MMA_MAX_DK``, ``"cuda_cores"`` for everything else (f32 and the
    other head dims)."""
    ok = dtype == torch.bfloat16 and dk % 16 == 0 and 16 <= dk <= MMA_MAX_DK
    return "mma" if ok else "cuda_cores"


def m_tiles(dv: int) -> int:
    return -(-dv // MMA_COLS)


def cluster_sizes(dv: int) -> range:
    """The cluster sizes the tensor-core kernel takes at dv: every block
    owns 1..``MMA_MAX_TILES`` m-tiles."""
    n = m_tiles(dv)
    return range(-(-n // MMA_MAX_TILES), min(MAX_CLUSTER, n) + 1)


def cluster_plan(chains: int, dv: int, fits: Callable[[int], int]) -> int:
    """Blocks a cluster of the tensor-core kernel (one cluster per (batch
    row, head): ``chains`` of them): the fewest waves (``fits(cs)``: how
    many clusters of cs blocks the card holds at once), since the chunks of
    a chain run in order and a second wave costs a whole extra pass over
    them; then the largest cluster (the fewest m-tiles a block).  Clusters
    are independent, so a shape that no plan holds at once runs in more
    waves."""
    best, best_waves = None, None
    for cs in reversed(cluster_sizes(dv)):
        n = fits(cs)
        if n < 1:
            continue
        waves = -(-chains // n)
        if best_waves is None or waves < best_waves:
            best, best_waves = cs, waves
    if best is None:
        raise ValueError(f"no cluster of the scan kernel fits on the card at "
                         f"dv {dv}")
    return best


@functools.lru_cache(maxsize=None)
def max_clusters(device_index: int, dk: int, dv: int, cs: int) -> int:
    """How many clusters of cs blocks at (dk, dv) the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    fn = build.load(MMA_KERNEL.source).ssm_scan_mma_max_clusters
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(dk, dv, cs, ctypes.byref(n))
    if err:
        raise RuntimeError(f"ssm_scan_mma_max_clusters: CUDA error {err}")
    return n.value


@functools.lru_cache(maxsize=None)
def card_cluster_plan(chains: int, dk: int, dv: int, device_index: int) -> int:
    """``cluster_plan`` on the card's cluster occupancy, once per shape."""
    return cluster_plan(chains, dv, functools.partial(
        max_clusters, device_index, dk, dv))


def _checked(q, k, v, log_g, state, chunk):
    """The shape and device rules both directions share → (b, h, s, dk, dv,
    chunk)."""
    check_operands(q, k, v)
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    if tuple(log_g.shape) != (b, h, s) or tuple(state.shape) != (b, h, dk,
                                                                 dv):
        raise ValueError(f"bad shapes log_g{tuple(log_g.shape)} "
                         f"state{tuple(state.shape)}")
    if log_g.device != q.device or state.device != q.device:
        raise ValueError("log_g and state must lie on q's device")
    chunk = chunk_for(s, chunk)
    if chunk > MAX_CHUNK or b > 65535 or h > 65535:
        raise ValueError(f"unsupported scan: chunk {chunk} (<= {MAX_CHUNK})")
    return b, h, s, dk, dv, chunk


def _operands(q, k, v, log_g, state, chunk):
    b, h, s, dk, dv, chunk = _checked(q, k, v, log_g, state, chunk)
    g = log_g.float()
    s0 = state.float().contiguous()
    o = torch.empty((b, s, h, dv), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    sf = torch.empty((b, h, dk, dv), dtype=torch.float32, device=q.device)
    return (b, h, s, dk, dv, chunk), g, s0, o, sf


def _strides(q, k, v, g, o):
    return (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *g.stride(),
            *o.stride()[:3])


def launch_cuda_cores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_g: torch.Tensor, state: torch.Tensor, *,
                      chunk: int = 64):
    """The CUDA-core kernel on any shape the wrapper takes (dk <=
    ``MAX_DK``), f32 or bf16."""
    (b, h, s, dk, dv, chunk), g, s0, o, sf = _operands(q, k, v, log_g,
                                                       state, chunk)
    if dk > MAX_DK:
        raise ValueError(f"unsupported scan: dk {dk} (<= {MAX_DK})")
    with torch.cuda.device(q.device):
        KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
               s0.data_ptr(), o.data_ptr(), sf.data_ptr(),
               b, h, s, dk, dv, chunk, *_strides(q, k, v, g, o),
               DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    return o, sf


def launch_mma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_g: torch.Tensor, state: torch.Tensor, *, chunk: int = 64,
               cs=None):
    """The tensor-core kernel: bf16, dk % 16 == 0 and dk <= ``MMA_MAX_DK``,
    q and k 16-byte aligned (bases and strides), with the card's cluster
    plan (or clusters of ``cs`` blocks)."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core scan takes bfloat16, got {q.dtype}")
    (b, h, s, dk, dv, chunk), g, s0, o, sf = _operands(q, k, v, log_g,
                                                       state, chunk)
    if route(q.dtype, dk) != "mma":
        raise ValueError(f"the tensor-core scan does not take dk {dk} "
                         f"(dk % 16 == 0, dk <= {MMA_MAX_DK})")
    check_16_bytes("TMA", q=q, k=k)
    cs = cs or card_cluster_plan(b * h, dk, dv, q.device.index)
    if cs not in cluster_sizes(dv):
        raise ValueError(f"the tensor-core scan does not take clusters of "
                         f"{cs} at dv {dv} (each block owns 1.."
                         f"{MMA_MAX_TILES} of its {m_tiles(dv)} m-tiles)")
    with torch.cuda.device(q.device):
        MMA_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                   s0.data_ptr(), o.data_ptr(), sf.data_ptr(),
                   b, h, s, dk, dv, chunk, cs, *_strides(q, k, v, g, o),
                   torch.cuda.current_stream().cuda_stream)
    return o, sf


def ssm_scan_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_g: torch.Tensor, state: torch.Tensor, *,
                  chunk: int = 64):
    """q, k: (B, H, S, dk); v: (B, H, S, dv), one dtype; log_g: (B, H, S);
    state: (B, H, dk, dv) → (o (B, H, S, dv) in q's dtype, final state
    (B, H, dk, dv) f32), on the card, through the kernel ``route`` names.
    ``o`` is a (B, H, S, dv) view of a (B, S, H, dv) buffer."""
    if q.dim() == 4 and route(q.dtype, q.shape[-1]) == "mma":
        return launch_mma(q, k, v, log_g, state, chunk=chunk)
    return launch_cuda_cores(q, k, v, log_g, state, chunk=chunk)



def _zeros_state(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The zero initial state (B, H, dk, dv) f32 of (B, ·, S, d) operands
    q and v (the kernel layout's dims 0 and 1, or the model layout's 0 and
    2, as the caller passes them)."""
    return torch.zeros((q.shape[0], q.shape[1], q.shape[-1], v.shape[-1]),
                       dtype=torch.float32, device=q.device)


def ssm_scan_model_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          log_g: torch.Tensor,
                          state: Optional[torch.Tensor] = None, *,
                          chunk: int = 64):
    """``ssm_scan_cuda`` in the model layout: q, k (B, S, H, dk), v (B, S,
    H, dv), log_g (B, S, H), state (B, H, dk, dv) or None (zeros) → (o (B,
    S, H, dv), final state f32), as transposed views, no copy."""
    q, k, v, log_g = (t.transpose(1, 2) for t in (q, k, v, log_g))
    o, sf = ssm_scan_cuda(q, k, v, log_g,
                          _zeros_state(q, v) if state is None else state,
                          chunk=chunk)
    return o.transpose(1, 2), sf


def ssm_scan_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_g: torch.Tensor, state: Optional[torch.Tensor],
                      do: torch.Tensor,
                      dstate_final: Optional[torch.Tensor] = None, *,
                      chunk: int = 64):
    """The backward kernel: the forward's operands in its (B, H, S, d)
    layout (``state`` (B, H, dk, dv) or None: zeros), ``do`` (B, H, S, dv)
    of q's dtype and ``dstate_final`` (B, H, dk, dv) or None (zero) → (dq,
    dk, dv as (B, H, S, d) views of (B, S, H, d) buffers in q's dtype,
    dlog_g (B, H, S) f32, a view of a (B, S, H) buffer, dstate (B, H, dk,
    dv) f32).  One C entry a call (four launches)."""
    check_operands(q, k, v, do)
    if state is None:
        state = _zeros_state(q, v)
    b, h, s, dk, dv, chunk = _checked(q, k, v, log_g, state, chunk)
    if do.shape != v.shape:
        raise ValueError(f"bad shape do{tuple(do.shape)}")
    if dk > BWD_MAX_DK:
        raise ValueError(f"unsupported scan backward: dk {dk} (<= "
                         f"{BWD_MAX_DK})")
    f32, dev = torch.float32, q.device
    g = log_g.float()
    s0 = state.float().contiguous()
    dsf = None
    if dstate_final is not None:
        if dstate_final.shape != state.shape or dstate_final.device != dev:
            raise ValueError("dstate_final must be (B, H, dk, dv) on q's "
                             "device")
        dsf = dstate_final.float().contiguous()
    dq, dk_ = (torch.empty((b, s, h, dk), dtype=q.dtype, device=dev)
               .transpose(1, 2) for _ in range(2))
    dv_ = torch.empty((b, s, h, dv), dtype=q.dtype, device=dev).transpose(1, 2)
    dg = torch.empty((b, s, h), dtype=f32, device=dev).transpose(1, 2)
    dstate = torch.empty((b, h, dk, dv), dtype=f32, device=dev)
    ns = -(-dv // BWD_COLS)
    states = torch.empty((b, h, s // chunk, dk, dv), dtype=f32, device=dev)
    pdq, pdk = (torch.empty((ns, b, h, s, dk), dtype=f32, device=dev)
                for _ in range(2))
    psf = torch.empty((ns, b, h), dtype=f32, device=dev)
    dcum = torch.empty((b, h, s), dtype=f32, device=dev)
    iq, ik = (torch.empty((b, h, s, dk), dtype=f32, device=dev)
              for _ in range(2))
    iv = torch.empty((b, h, s, dv), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        BWD_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                   g.data_ptr(), s0.data_ptr(),
                   None if dsf is None else dsf.data_ptr(), dq.data_ptr(),
                   dk_.data_ptr(), dv_.data_ptr(), dg.data_ptr(),
                   dstate.data_ptr(), states.data_ptr(), pdq.data_ptr(),
                   pdk.data_ptr(), psf.data_ptr(), dcum.data_ptr(),
                   iq.data_ptr(), ik.data_ptr(), iv.data_ptr(),
                   b, h, s, dk, dv, chunk,
                   *(x for t in (q, k, v, do) for x in t.stride()[:3]),
                   *g.stride(),
                   *(x for t in (dq, dk_, dv_) for x in t.stride()[:3]),
                   *dg.stride(), DTYPES[q.dtype],
                   torch.cuda.current_stream().cuda_stream)
    return dq, dk_, dv_, dg, dstate


class SsmScanFn(torch.autograd.Function):
    """The chunked scan under autograd, in the model layout: q, k (B, S, H,
    dk), v (B, S, H, dv), log_g (B, S, H), state (B, H, dk, dv) or None →
    (o (B, S, H, dv), final state f32), as ``ops.ssm_scan``.  On the card
    the forward is ``ssm_scan_cuda`` (its route) and the backward
    ``ssm_scan_bwd_cuda``; on the CPU both are the plain versions.  It
    saves its inputs alone: the backward recomputes the chunk-start
    states, as the JAX package's autodiff of the reference keeps only
    what its ``lax.scan`` carries."""

    @staticmethod
    def forward(ctx, q, k, v, log_g, state, chunk):
        ctx.set_materialize_grads(False)
        fwd = (ssm_scan_model_layout if q.device.type == "cuda"
               else ref.ssm_scan)
        o, sf = fwd(q, k, v, log_g, state, chunk=chunk)
        ctx.save_for_backward(q, k, v, log_g, state)
        ctx.chunk = chunk
        return o, sf

    @staticmethod
    def backward(ctx, do, dsf):
        q, k, v, log_g, state = ctx.saved_tensors
        if do is None:
            do = torch.zeros(v.shape, dtype=q.dtype, device=q.device)
        do = do.to(q.dtype)
        if q.device.type == "cuda":
            if do.stride(-1) != 1:
                do = do.contiguous()
            dq, dk_, dv, dg, ds = ssm_scan_bwd_cuda(
                *(t.transpose(1, 2) for t in (q, k, v, log_g)), state,
                do.transpose(1, 2), dsf, chunk=ctx.chunk)
            dq, dk_, dv, dg = (t.transpose(1, 2) for t in (dq, dk_, dv, dg))
        else:
            dq, dk_, dv, dg, ds = ref.ssm_scan_bwd(q, k, v, log_g, state, do,
                                                   dsf, chunk=ctx.chunk)
        return (dq, dk_, dv, dg.to(log_g.dtype),
                None if state is None else ds.to(state.dtype), None)
