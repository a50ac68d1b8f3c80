"""The tensor-core flash backward's rules and arithmetic on the CPU.

The kernel (``csrc/flash_attention_bwd_wgmma.cu``) runs only on the card
(``tests/test_torch_cuda.py``, marked ``cuda``).  Here: which dtypes and
head dims take it, and over how many blocks its dK/dV pass splits a KV
head's group; an emulation of what it computes (f32 S and dP, p
recomputed from the forward's lse, P and dS rounded to bf16 before dV, dK
and dQ) within its bound, 1e-4·G + 2^-6·|want| + 2^-8·A per element (want
the f32 plain version, G the largest |want| over dq, dk and dv, A the same
products over absolute values: 2^-8·A is the worst case of the two
roundings alone), with room (at most 0.6 of it); the plain version that
bound is taken from against ``jax.vjp`` of the JAX package's
``flash_structured`` (``flash_attention`` where Sq < Skv), within
1e-5·(1 + max|want|); and the forward's lse residual, as the port defines
it, against JAX's ``_fs_fwd`` residual within 1e-5.  Inputs are made from a
seed with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest's workers share the cores, and torch's
# default of a thread a core in each worker oversubscribes them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as JR  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels.flash_attention import bwd_route, route  # noqa: E402


def test_flash_bwd_route_rule():
    """bf16 at hd 64/128/256 takes the tensor-core backward (where the
    forward's route is wgmma too, so its forward saved lse: gemma3-1b's
    hd 256 among them); float32 and other head dims take the CUDA cores;
    any other dtype raises."""
    assert bwd_route(torch.bfloat16, 64) == bwd_route(
        torch.bfloat16, 128) == bwd_route(torch.bfloat16, 256) == "wgmma"
    for dtype, hd in [(torch.float32, 128), (torch.float32, 64),
                      (torch.float32, 256), (torch.bfloat16, 16),
                      (torch.bfloat16, 12), (torch.bfloat16, 96)]:
        assert bwd_route(dtype, hd) == "cuda_cores"
    for dtype in (torch.bfloat16, torch.float32):
        for hd in (12, 64, 128, 256):
            assert bwd_route(dtype, hd) == route(dtype, hd)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            bwd_route(dtype, 128)


def test_flash_bwd_splits_rule():
    """The dK/dV pass splits a KV head's group over the divisor of the
    group its cost model prefers: at the 2B's training shapes on an H100's
    132 SMs, 2 blocks at S 1025 (136 unsplit blocks, one a SM: the pass
    is its heaviest block's 102 pairs) and none at S 2048 (256 blocks, two
    waves that balance); at gemma3-1b's (B 4 x S 1025, 4/1 heads, hd 256,
    a global layer: 68 unsplit blocks, the first key tile's 68 pairs) all
    4 heads apart, which an H100 measured fastest (0.079 ms against 0.123
    at 2 and 0.236 unsplit), and at its local layers' window 512 two
    blocks (136 blocks of 18 pairs: at 4, 272 blocks make a short third
    wave, and the H100 measured 0.0718 ms + 0.0054 for the sum at 2
    against 0.0742 + 0.0104 at 4); a group of 1 never splits, and every
    answer divides the group."""
    from repro_torch.kernels.flash_attention import (bwd_makespan,
                                                     bwd_pairs, bwd_splits)
    assert bwd_splits(4, 2, 6, 128, 1025, 1025, True, 0, 132) == 2
    assert bwd_splits(4, 2, 6, 128, 2048, 2048, True, 0, 132) == 1
    assert bwd_pairs(4, 1, 4, 1025, 1025, True, 0) == (68, 2448)
    assert bwd_splits(4, 1, 4, 256, 1025, 1025, True, 0, 132) == 4
    assert bwd_pairs(4, 1, 4, 1025, 1025, True, 512) == (36, 1872)
    assert [bwd_makespan(4, 1, 4, 1025, 1025, True, 512, d, 132)
            for d in (1, 2, 4)] == [36, 18, 18]
    assert bwd_splits(4, 1, 4, 256, 1025, 1025, True, 512, 132) == 2
    for group in (1, 5, 6, 7, 16):
        for sq, skv, window in ((1, 1, 0), (65, 300, 100), (4096, 4096, 0)):
            d = bwd_splits(2, 2, group, 64, sq, skv, True, window, 132)
            assert group % d == 0
    assert bwd_splits(8, 8, 1, 128, 8192, 8192, True, 0, 132) == 1


def _emulate_wgmma_bwd(q, k, v, o, do, lse, *, window=0, softcap=None):
    """What the tensor-core backward computes, in float32 on the CPU: S and
    dP in f32 from the bf16 operands, p = exp(x - lse) with the forward's
    lse, delta = rowsum(dO·O), dS = p·(dP - delta)·(1 - tanh²); P and dS
    rounded to bf16 before dV = Pᵀ·dO, dK = scale·dSᵀ·Q and dQ =
    scale·dS·K; the gradients rounded to bf16.  Bottom-right causal.  At
    hd 256 dS multiplies as the kernel's hand-over does, (p·(1 -
    tanh²))·(dP - delta)."""
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = hd ** -0.5
    qf = q.float().reshape(b, sq, kh, g, hd)
    dof = do.float().reshape(b, sq, kh, g, hd)
    kf, vf = k.float(), v.float()
    x = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    dcap = 1.0
    if softcap is not None:
        t = torch.tanh(x / softcap)
        x, dcap = softcap * t, 1.0 - t * t
    rows = torch.arange(sq)[:, None] + (skv - sq)
    cols = torch.arange(skv)[None, :]
    mask = cols <= rows
    if window > 0:
        mask &= cols > rows - window
    lse = lse.reshape(b, kh, g, sq)[..., None]
    p = torch.where(mask, torch.exp(x - lse), torch.zeros(()))
    delta = (dof * o.float().reshape(b, sq, kh, g, hd)).sum(-1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    dp = dp - delta.permute(0, 2, 3, 1)[..., None]
    ds = (p * dcap) * dp if hd == 256 else p * dp * dcap
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dq = torch.einsum("bkgqs,bskd->bqkgd", dsb, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", dsb, qf) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", pb, dof)
    return (dq.reshape(b, sq, h, hd).bfloat16(), dk.bfloat16(),
            dv.bfloat16())


def wgmma_bwd_bound_share(got, q, k, v, o, do, **kw):
    """The largest share of 1e-4·G + 2^-6·|want| + 2^-8·A any element of
    (dq, dk, dv) uses, want the f32 plain version (``chip_smoke.py``'s
    ``check_bwd_wgmma`` holds the kernel to the same bound)."""
    f32 = [t.float() for t in (q, k, v, o, do)]
    want = R.flash_attention_bwd(*f32, **kw)
    a = R.flash_attention_bwd_abs(*f32, **kw)
    big = max(float(w.abs().max()) for w in want)
    return max(float(((g.float() - w).abs()
                      / (1e-4 * big + 2.0 ** -6 * w.abs() + 2.0 ** -8 * x))
                     .max())
               for g, w, x in zip(got, want, a))


def _vjp(f, q, k, v, do):
    return jax.jit(lambda q, k, v, do: jax.vjp(f, q, k, v)[1](do))(
        q, k, v, do)


@pytest.mark.parametrize("group,kh,hd,sq,skv,window,softcap", [
    (7, 1, 128, 128, 128, 0, None),
    (6, 1, 64, 65, 200, 0, None),
    (2, 2, 64, 192, 192, 50, None),
    (3, 2, 128, 128, 128, 0, 5.0),
    (4, 1, 256, 192, 192, 40, None),
    (4, 1, 256, 128, 128, 0, 5.0),
    (4, 1, 256, 65, 200, 30, None)],
    ids=["group7_hd128", "group6_hd64_sq65_skv200", "window", "softcap",
         "hd256_window", "hd256_softcap", "hd256_sq65_skv200"])
def test_flash_bwd_wgmma_emulation_within_bound(group, kh, hd, sq, skv,
                                                window, softcap):
    """The emulated route on bf16 inputs stays within 0.6 of its bound; the
    f32 plain version the bound is taken from equals JAX's VJP."""
    rng = np.random.default_rng(group * 1000 + sq + window)
    h = kh * group
    q, do = (torch.from_numpy(rng.standard_normal((1, sq, h, hd))
                              .astype(np.float32)).bfloat16()
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, skv, kh, hd))
                             .astype(np.float32)).bfloat16()
            for _ in range(2))
    kw = {"window": window, "softcap": softcap}
    o = R.flash_attention(q, k, v, **kw)                 # bf16, as the card's
    lse = R.flash_attention_lse(q, k, **kw)
    got = _emulate_wgmma_bwd(q, k, v, o, do, lse, **kw)
    assert wgmma_bwd_bound_share(got, q, k, v, o, do, **kw) <= 0.6

    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    want = R.flash_attention_bwd(qf, kf, vf, R.flash_attention(qf, kf, vf,
                                                               **kw),
                                 dof, **kw)
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (qf, kf, vf, dof))
    if sq == skv:
        jwant = _vjp(lambda q, k, v: JR.flash_structured(
            q, k, v, True, window, softcap, None, 64, 64), jq, jk, jv, jdo)
    else:
        jwant = _vjp(lambda q, k, v: JR.flash_attention(
            q, k, v, causal=True, window=window, softcap=softcap),
            jq, jk, jv, jdo)
    for g, w in zip(want, jwant):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * (1 + np.abs(w).max()))


@pytest.mark.parametrize("window,softcap", [(0, None), (40, None),
                                            (0, 5.0)],
                         ids=["causal", "window", "softcap"])
def test_flash_lse_matches_jax_fs_fwd_residual(window, softcap):
    """lse as the forward defines it, m + log(max(l, 1e-30)) per row, is
    the JAX package's ``_fs_fwd`` residual on the same inputs."""
    rng = np.random.default_rng(7 + window)
    b, s, kh, g, hd, blk = 2, 128, 2, 3, 64, 64
    q = rng.standard_normal((b, s, kh * g, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kh, hd)).astype(np.float32)
            for _ in range(2))
    got = R.flash_attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                                window=window, softcap=softcap)
    _, (*_, lse) = JR._fs_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              True, window, softcap, None, blk, blk)
    # (n_q_blocks, b, kh, g, q_blk) → (b, h, s)
    want = np.asarray(lse).transpose(1, 2, 3, 0, 4).reshape(b, kh * g, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
