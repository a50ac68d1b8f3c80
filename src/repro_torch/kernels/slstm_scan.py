"""The stabilised sLSTM recurrence: the wrapper around ``csrc/slstm_scan.cu``.

Unlike the Pallas kernel, it starts from an initial (h, c, n, m) state
operand (the serving path carries one through prefill and every decode
step).  ``state=None`` is the zero start of the JAX oracle (h = c = m = 0,
n = 1e-6).  float32 only: the model computes the gates in f32.

Two routes, chosen by ``route`` from P alone:

* ``"cluster"`` (P >= 64): one thread-block cluster per (head, batch
  group) holds the head's R in registers, split over its blocks by units,
  and exchanges h through distributed shared memory each step (stores
  counted on the receiver's mbarrier: no cluster barrier in the loop).
  ``cluster_plan`` picks the cluster size and the group's rows on the
  card's cluster occupancy.
* ``"per_row"`` (P < 64): one block per (head, batch row), 4P threads, R
  read from L2 every step (the first port), whose short steps beat the
  cluster's exchange at small P (the reduced proxies' P 16).

Both raise on what they do not take; neither falls back to the other.

The backward (training) is one kernel, ``csrc/slstm_scan_bwd.cu``: a
thread-block cluster of ``bwd_cluster_size(P)`` blocks per (batch row,
head) walks the steps in reverse, each block holding its units' rows of
R[h] in shared memory and exchanging each step's gate gradients through
distributed shared memory.  It takes the pre-activations, which the
wrapper recomputes from the forward's h sequence in one product, and
recomputes (c, n, m) itself; dR is one product after it.  ``SlstmScanFn``
ties forward and backward together for autograd: on the card the forward
is ``slstm_scan_cuda`` and the backward ``slstm_scan_bwd_cuda``; on the
CPU both are the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import CudaKernel, check_operands

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("slstm_scan.cu", "slstm_scan_fwd",
                    [_P] * 11 + [_I] * 4 + [_L] * 4 + [_P])
CLUSTER_KERNEL = CudaKernel("slstm_scan.cu", "slstm_scan_cluster_fwd",
                            [_P] * 11 + [_I] * 4 + [_L] * 4
                            + [_I, _I, _P])
BWD_KERNEL = CudaKernel("slstm_scan_bwd.cu", "slstm_scan_bwd",
                        [_P] * 16 + [_I] * 5 + [_P])
BWD_MAX_CLUSTER = 8   # the backward's clusters stay portable
BWD_UNITS = 24        # units a block of the backward aims at
MAX_THREADS = 1024    # 4P <= this: the per-row route's threads a block
MAX_CLUSTER = 16      # blocks a cluster (more than 8 is non-portable)
DEPTH = 4             # steps of gates_x in the cluster kernel's ring
LANE_ROWS = (1, 2, 4, 6, 8)   # the kernel's instances: rows of R a lane holds
SMEM_LIMIT = 231424   # dynamic shared memory a block may use (226 KB)
#: the least P that takes the cluster route: below it a step of the
#: per-row kernel (a P-long dot product from L2) is shorter than the
#: cluster kernel's exchange.  Timed over P 8-64 at S 4096 (B 1 H 1, B 4
#: H 4) by tools/slstm_probe.py: per-row faster up to P 48, the cluster
#: kernel from P 64
CLUSTER_MIN_P = 64


def lane_rows(p_dim: int) -> int:
    """Rows of R a lane holds per gate: the least instance with 32·NQ >= P
    (lane l holds rows l, l + 32, ...)."""
    return next(n for n in LANE_ROWS if 32 * n >= p_dim)


def block_limit(p_dim: int) -> int:
    """Threads a block of the cluster kernel may have (its launch bounds:
    768 where a lane holds 6 or more rows of R)."""
    return 768 if lane_rows(p_dim) >= 6 else 1024


def units_per_block(p_dim: int, cs: int) -> int:
    return -(-p_dim // cs)


def row_stride(bt: int) -> int:
    """The kernel's row stride of h: the group's rows, padded beyond two
    rows to whole 16-byte chunks ≡ 4 (mod 8) floats (no bank conflict)."""
    if bt <= 2:
        return bt
    r4 = -(-bt // 4) * 4
    return r4 if r4 % 8 == 4 else r4 + 4


def smem_bytes(p_dim: int, cs: int, bt: int) -> int:
    """A block's dynamic shared memory: two h buffers of 32·NQ rows, the
    gates ring, the (c, n, m) state, the step's pre-activations and the R
    staging."""
    up = units_per_block(p_dim, cs)
    hs = row_stride(bt)
    return 4 * (2 * 32 * lane_rows(p_dim) * hs + DEPTH * bt * 4 * up
                + 3 * bt * up + 4 * up * hs + 32 * (4 * up + 1))


def plan_fits_block(p_dim: int, cs: int, bt: int) -> bool:
    """The kernel takes (cs, bt) at P: at most MAX_CLUSTER blocks, each
    owning at least one unit, within its thread and shared-memory limits."""
    if not (1 <= cs <= MAX_CLUSTER and bt >= 1):
        return False
    up = units_per_block(p_dim, cs)
    return ((cs - 1) * up < p_dim and 32 * up <= block_limit(p_dim)
            and smem_bytes(p_dim, cs, bt) <= SMEM_LIMIT)


def cluster_plan(b: int, heads: int, p_dim: int,
                 fits: Callable[[int, int], int]) -> Tuple[int, int]:
    """(cs, bt) of the cluster kernel: clusters of cs blocks, one per
    (head, group of bt batch rows; the last group may be shorter), in the
    fewest waves (``fits(cs, bt)``: how many such clusters the card holds
    at once): every cluster resident at once wherever some plan allows it,
    since a second wave costs a whole extra pass over S dependent steps.
    Clusters are independent of each other, so a shape that no plan holds
    at once (many heads or a large batch) runs in more waves.  Of the
    plans with the fewest waves, the largest cluster (the fewest units, so
    the fewest warps, a block), then the fewest groups (the fewest blocks
    sharing an SM)."""
    best, best_key = None, None
    for cs in range(MAX_CLUSTER, 0, -1):
        for bt in sorted({-(-b // g) for g in range(1, b + 1)},
                         reverse=True):
            if not plan_fits_block(p_dim, cs, bt):
                continue
            n = fits(cs, bt)
            if n < 1:
                continue
            key = -(-heads * -(-b // bt) // n)        # waves
            if best_key is None or key < best_key:
                best, best_key = (cs, bt), key
    if best is None:
        raise ValueError(f"no cluster of the kernel fits on the card at P "
                         f"{p_dim}")
    return best


@functools.lru_cache(maxsize=None)
def max_clusters(device_index: int, p_dim: int, cs: int, bt: int) -> int:
    """How many clusters of cs blocks over bt rows at P the card holds at
    once (``cudaOccupancyMaxActiveClusters``)."""
    fn = build.load(CLUSTER_KERNEL.source).slstm_scan_cluster_max_clusters
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(p_dim, cs, bt, ctypes.byref(n))
    if err:
        raise RuntimeError(f"slstm_scan_cluster_max_clusters: CUDA error "
                           f"{err}")
    return n.value


@functools.lru_cache(maxsize=None)
def card_cluster_plan(b: int, heads: int, p_dim: int,
                      device_index: int) -> Tuple[int, int]:
    """``cluster_plan`` on the card's cluster occupancy, computed once per
    shape."""
    return cluster_plan(b, heads, p_dim, functools.partial(
        max_clusters, device_index, p_dim))


def route(p_dim: int) -> str:
    """The kernel a shape takes: ``"cluster"`` from P = CLUSTER_MIN_P up,
    ``"per_row"`` below it.  Both take every shape the wrapper does (the
    cluster route in more than one wave where the card cannot hold all its
    clusters at once)."""
    return "cluster" if p_dim >= CLUSTER_MIN_P else "per_row"


def bwd_cluster_size(p_dim: int) -> int:
    """Blocks a cluster of the backward kernel at P: about ``BWD_UNITS``
    units a block (R[h]'s rows of them in shared memory, one step's
    product split over the blocks), at most ``BWD_MAX_CLUSTER``, each block
    owning at least one unit."""
    cs = min(BWD_MAX_CLUSTER, max(1, -(-p_dim // BWD_UNITS)))
    while cs > 1 and (cs - 1) * -(-p_dim // cs) >= p_dim:
        cs -= 1
    return cs


def _checked(gates_x, r):
    """The shape rules both directions share → (b, s, heads, p_dim)."""
    check_operands(gates_x, r)
    if gates_x.dtype != torch.float32:
        raise TypeError(f"the sLSTM kernel takes float32, got "
                        f"{gates_x.dtype}")
    if gates_x.dim() != 3 or r.dim() != 3 or r.shape[2] != 4 * r.shape[1]:
        raise ValueError(f"bad shapes gates_x{tuple(gates_x.shape)} "
                         f"r{tuple(r.shape)}")
    b, s, d4 = gates_x.shape
    heads, p_dim = r.shape[0], r.shape[1]
    if d4 != 4 * heads * p_dim:
        raise ValueError(f"gates_x width {d4} != 4·H·P = {4 * heads * p_dim}")
    if 4 * p_dim > MAX_THREADS or b > 65535 or s < 1:
        raise ValueError(f"unsupported sLSTM: P {p_dim} (4P <= "
                         f"{MAX_THREADS}), S {s}")
    return b, s, heads, p_dim


def _state(state, b, heads, p_dim, device):
    """The initial (h, c, n, m), each (B, H, P) f32 contiguous on the
    gates' device (None: the zero start)."""
    if state is None:
        state = ref.slstm_zero_state(b, heads, p_dim, device)
    st = []
    for x in state:
        if x.device != device or x.numel() != b * heads * p_dim:
            raise ValueError("each state leaf must be (B, H, P) on the "
                             "gates' device")
        st.append(x.float().reshape(b, heads, p_dim).contiguous())
    return st


def _operands(gates_x, r, state):
    b, s, heads, p_dim = _checked(gates_x, r)
    st = _state(state, b, heads, p_dim, gates_x.device)
    h = torch.empty((b, s, heads * p_dim), dtype=torch.float32,
                    device=gates_x.device)
    final = tuple(torch.empty((b, heads, p_dim), dtype=torch.float32,
                              device=gates_x.device) for _ in range(4))
    return (b, s, heads, p_dim), r.contiguous(), st, h, final


def launch_per_row(gates_x: torch.Tensor, r: torch.Tensor, state=None):
    """The per-row kernel on any shape the wrapper takes."""
    (b, s, heads, p_dim), rc, st, h, final = _operands(gates_x, r, state)
    with torch.cuda.device(gates_x.device):
        KERNEL(gates_x.data_ptr(), rc.data_ptr(),
               *(x.data_ptr() for x in st), h.data_ptr(),
               *(x.data_ptr() for x in final), b, s, heads, p_dim,
               gates_x.stride(0), gates_x.stride(1), h.stride(0),
               h.stride(1), torch.cuda.current_stream().cuda_stream)
    return h, final


def launch_cluster(gates_x: torch.Tensor, r: torch.Tensor, state=None, *,
                   plan=None):
    """The cluster kernel on any shape the wrapper takes, with the card's
    plan (or the given ``plan`` = (cs, bt))."""
    (b, s, heads, p_dim), rc, st, h, final = _operands(gates_x, r, state)
    dev = gates_x.device.index
    cs, bt = plan or card_cluster_plan(b, heads, p_dim, dev)
    if not plan_fits_block(p_dim, cs, bt):
        raise ValueError(f"the cluster kernel does not take (cs {cs}, bt "
                         f"{bt}) at P {p_dim}")
    with torch.cuda.device(gates_x.device):
        CLUSTER_KERNEL(gates_x.data_ptr(), rc.data_ptr(),
                       *(x.data_ptr() for x in st), h.data_ptr(),
                       *(x.data_ptr() for x in final), b, s, heads, p_dim,
                       gates_x.stride(0), gates_x.stride(1), h.stride(0),
                       h.stride(1), cs, bt,
                       torch.cuda.current_stream().cuda_stream)
    return h, final


def slstm_scan_cuda(gates_x: torch.Tensor, r: torch.Tensor, state=None):
    """gates_x: (B, S, 4d) f32; r: (H, P, 4P) f32; state: (h, c, n, m) each
    (B, H, P) (or (B, d)) f32, or None → (h (B, S, d) f32, final (h, c, n,
    m) each (B, H, P) f32), on the card, through the kernel ``route``
    names."""
    if r.dim() == 3 and route(r.shape[1]) == "cluster":
        return launch_cluster(gates_x, r, state)
    return launch_per_row(gates_x, r, state)


def slstm_scan_bwd_cuda(gates_x: torch.Tensor, r: torch.Tensor, state,
                        hs: torch.Tensor, dh: torch.Tensor, dfinal=None):
    """The backward kernel: the forward's operands, its h sequence ``hs``
    (B, S, d), the cotangent ``dh`` (B, S, d) and ``dfinal`` (the final (h,
    c, n, m)'s, entries (B, H, P) or None) → (dgates_x (B, S, 4d) f32, dr
    (H, P, 4P) f32, the initial (h, c, n, m)'s gradients, each (B, H, P)
    f32).  The pre-activations gates_x + h_{t-1}·R[h]
    (``ref.slstm_preactivations``, in the kernel's (B, S, 4, H, P) layout)
    and dR = Σ_t h_{t-1}ᵀ dg_t are one plain matrix product each, before
    and after the kernel; one C entry a call."""
    b, s, heads, p_dim = _checked(gates_x, r)
    dev, f32 = gates_x.device, torch.float32
    d = heads * p_dim
    st = _state(state, b, heads, p_dim, dev)
    for name, t in (("hs", hs), ("dh", dh)):
        if t.shape != (b, s, d) or t.device != dev:
            raise ValueError(f"{name} must be (B, S, d) on the gates' device")
    rc = r.contiguous()
    gp, h_prev = ref.slstm_preactivations(gates_x, rc, st[0], hs)
    gp = gp.contiguous()                               # (B, S, 4, H, P)
    h_heads = h_prev.reshape(b * s, heads, p_dim).transpose(0, 1)
    dhc = dh.float().contiguous()
    dfin = [None if x is None else x.float().reshape(b, d).contiguous()
            for x in (dfinal or (None,) * 4)]
    dg = torch.empty_like(gp)
    cnm = torch.empty((3, b, s, d), dtype=f32, device=dev)
    d0 = [torch.empty((b, heads, p_dim), dtype=f32, device=dev)
          for _ in range(4)]
    with torch.cuda.device(dev):
        BWD_KERNEL(gp.data_ptr(), rc.data_ptr(),
                   *(x.data_ptr() for x in st[1:]), dhc.data_ptr(),
                   *(None if x is None else x.data_ptr() for x in dfin),
                   dg.data_ptr(), cnm.data_ptr(),
                   *(x.data_ptr() for x in d0), b, s, heads, p_dim,
                   bwd_cluster_size(p_dim),
                   torch.cuda.current_stream().cuda_stream)
    dgh = dg.permute(3, 0, 1, 2, 4).reshape(heads, b * s, 4 * p_dim)
    dr = torch.matmul(h_heads.transpose(1, 2), dgh)   # (H, P, 4P)
    return dg.reshape(b, s, 4 * d), dr, tuple(d0)


class SlstmScanFn(torch.autograd.Function):
    """The sLSTM recurrence under autograd: gates_x (B, S, 4d), r (H, P,
    4P) and the initial h, c, n, m (each (B, H, P) or (B, d); all four None
    for the zero start) → (h (B, S, d), h, c, n, m final), as
    ``ops.slstm_scan``.  On the card the forward is ``slstm_scan_cuda``
    and the backward ``slstm_scan_bwd_cuda``; on the CPU both are the plain
    versions.  It saves its inputs and the h sequence: the backward
    recomputes the pre-activations and (c, n, m) from them."""

    @staticmethod
    def forward(ctx, gates_x, r, h0, c0, n0, m0):
        ctx.set_materialize_grads(False)
        state = None if h0 is None else (h0, c0, n0, m0)
        if gates_x.device.type == "cuda":
            hs, final = slstm_scan_cuda(gates_x, r, state)
        else:
            hs, final = ref.slstm_scan(gates_x, r, state)
        ctx.save_for_backward(gates_x, r, h0, c0, n0, m0, hs)
        return (hs, *final)

    @staticmethod
    def backward(ctx, dhs, *dfinal):
        gates_x, r, h0, c0, n0, m0, hs = ctx.saved_tensors
        state = None if h0 is None else (h0, c0, n0, m0)
        if dhs is None:
            dhs = torch.zeros_like(hs)
        if gates_x.device.type == "cuda":
            dgx, dr, ds = slstm_scan_bwd_cuda(gates_x, r, state, hs, dhs,
                                              dfinal)
        else:
            dgx, dr, ds = ref.slstm_scan_bwd(gates_x, r, state, hs, dhs,
                                             dfinal)
        if state is None:
            return dgx.to(gates_x.dtype), dr.to(r.dtype), None, None, None, \
                None
        return (dgx.to(gates_x.dtype), dr.to(r.dtype),
                *(g.reshape(x.shape).to(x.dtype) for g, x in zip(ds, state)))
