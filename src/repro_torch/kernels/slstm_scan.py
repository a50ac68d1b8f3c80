"""The stabilised sLSTM recurrence: the wrapper around ``csrc/slstm_scan.cu``.

One block per (head, batch row) walks the S steps with 4P threads; unlike
the Pallas kernel, it starts from an initial (h, c, n, m) state operand
(the serving path carries one through prefill and every decode step).
``state=None`` is the zero start of the JAX oracle (h = c = m = 0,
n = 1e-6).  float32 only: the model computes the gates in f32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, check_operands

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("slstm_scan.cu", "slstm_scan_fwd",
                    [_P] * 11 + [_I] * 4 + [_L] * 4 + [_P])
MAX_THREADS = 1024   # 4P threads a block


def slstm_scan_cuda(gates_x: torch.Tensor, r: torch.Tensor, state=None):
    """gates_x: (B, S, 4d) f32; r: (H, P, 4P) f32; state: (h, c, n, m) each
    (B, H, P) (or (B, d)) f32, or None → (h (B, S, d) f32, final (h, c, n,
    m) each (B, H, P) f32), on the card."""
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
    if state is None:
        state = ref.slstm_zero_state(b, heads, p_dim, gates_x.device)
    st = []
    for x in state:
        if x.device != gates_x.device or x.numel() != b * heads * p_dim:
            raise ValueError("each state leaf must be (B, H, P) on the "
                             "gates' device")
        st.append(x.float().reshape(b, heads, p_dim).contiguous())
    rc = r.contiguous()
    h = torch.empty((b, s, heads * p_dim), dtype=torch.float32,
                    device=gates_x.device)
    final = tuple(torch.empty((b, heads, p_dim), dtype=torch.float32,
                              device=gates_x.device) for _ in range(4))
    with torch.cuda.device(gates_x.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL(gates_x.data_ptr(), rc.data_ptr(),
               *(x.data_ptr() for x in st), h.data_ptr(),
               *(x.data_ptr() for x in final), b, s, heads, p_dim,
               gates_x.stride(0), gates_x.stride(1), h.stride(0),
               h.stride(1), stream)
    return h, final
