"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: every test skips without a CUDA device (it needs the card
and ``nvcc``).  Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances, element by element: attention 1e-4 absolute in float32 (TF32
off) and 1e-5 + 2^-6·|want| in bfloat16 (two bfloat16 ulps: both sides
round an f32 result), except the tensor-core routes of flash, decode and
prefix-append attention, which round p to bfloat16 before PV and are held
to 1e-5 + 2^-6·|want| + 2^-8·attention(q, k, |v|); the flash backward
1e-4·G (G the largest |want| over dq, dk, dv), + 2^-6·|want| in bf16,
and on its tensor-core route (P and dS rounded to bf16) + 2^-8·A, A the
same products over absolute values; region scores, f32 math and output,
1e-5 absolute;
the scans 1e-4 + 1e-4·|want| (f32 on both sides, another summation order),
a bf16 scan output 1e-4 + 2^-6·|want|, the sLSTM 2e-4 + 2e-4·|want|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    bwd_route, flash_attention_cuda)
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    paged_decode_attention_cuda)
from repro_torch.kernels.paged_prefill_attention import (  # noqa: E402
    paged_prefill_attention_cuda)
from repro_torch.kernels.slstm_scan import slstm_scan_cuda  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_cuda  # noqa: E402

pytestmark = pytest.mark.cuda

# (absolute, relative to |want|)
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-5, 2.0 ** -6)}
TOL_REGION = (1e-5, 0.0)
TOL_SCAN = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-4, 2.0 ** -6)}
TOL_SLSTM = (2e-4, 2e-4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _close(got, want, tol):
    atol, rtol = tol
    got, want = got.float(), want.float()
    bad = (got - want).abs() > atol + rtol * want.abs()
    assert not bool(bad.any()), float((got - want).abs().max())


def _within_wgmma_bound(got, q, k, v, **kw):
    """The tensor-core flash route rounds p to bf16 before PV: it is held
    to 1e-5 + 2^-6·|want| + 2^-8·A, A = attention(q, k, |v|) in f32."""
    qf, kf, vf = q.float(), k.float(), v.float()
    want = ref.flash_attention(qf, kf, vf, **kw)
    a = ref.flash_attention(qf, kf, vf.abs(), **kw)
    bound = 1e-5 + 2.0 ** -6 * want.abs() + 2.0 ** -8 * a
    diff = (got.float() - want).abs()
    assert not bool((diff > bound).any()), float(diff.max())


@pytest.mark.parametrize("hd,group,sq,skv,window,softcap,dtype", [
    (12, 3, 33, 33, 0, None, torch.float32),
    (16, 2, 70, 70, 16, None, torch.float32),
    (16, 2, 9, 50, 0, 5.0, torch.float32),
    (128, 7, 1025, 1025, 0, None, torch.bfloat16),     # wgmma route
    (128, 6, 200, 200, 0, None, torch.float32),
    (64, 6, 300, 300, 0, None, torch.bfloat16),        # wgmma route
    (128, 7, 65, 300, 100, 30.0, torch.bfloat16),      # wgmma, ragged
    (16, 3, 65, 65, 0, None, torch.bfloat16),          # CUDA cores in bf16
])
def test_flash_attention_kernel_matches_plain(card, hd, group, sq, skv,
                                              window, softcap, dtype):
    """Each case through ``ops`` on the route ``route`` names: the wgmma
    route held to its bound, the CUDA-core route to ``TOL``; the launch
    counted on the route's own key."""
    from repro_torch.kernels.flash_attention import route
    kh = 2
    q = _randn(card, 1, sq, kh * group, hd, dtype=dtype)
    k = _randn(card, 1, skv, kh, hd, dtype=dtype)
    v = _randn(card, 1, skv, kh, hd, dtype=dtype)
    wgmma = route(dtype, hd) == "wgmma"
    before = ops.launch_counts()
    got = ops.flash_attention(q, k, v, window=window, softcap=softcap)
    after = ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert (after["flash_attention_wgmma"]
            == before["flash_attention_wgmma"] + int(wgmma))
    if wgmma:
        _within_wgmma_bound(got, q, k, v, window=window, softcap=softcap)
    else:
        _close(got, ref.flash_attention(q, k, v, window=window,
                                        softcap=softcap), TOL[dtype])


def test_flash_wgmma_one_warpgroup_blocks_match_plain(card):
    """A grid of at least two blocks an SM (B 2 x 28 heads x 17 tiles =
    952) takes the one-consumer-warpgroup block: held to the wgmma bound
    at the 7B's heads and head dim."""
    q = _randn(card, 2, 1025, 28, 128, dtype=torch.bfloat16)
    k = _randn(card, 2, 1025, 4, 128, dtype=torch.bfloat16)
    v = _randn(card, 2, 1025, 4, 128, dtype=torch.bfloat16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert 2 * 28 * 17 >= 2 * sms
    before = ops.launch_counts()["flash_attention_wgmma"]
    got = ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention_wgmma"] == before + 1
    _within_wgmma_bound(got, q, k, v)


def test_flash_wgmma_route_refuses_misaligned_views(card):
    """TMA's 16-byte rule is checked before the launch: a misaligned view
    raises, it never takes the CUDA-core route."""
    buf = _randn(card, 1, 70, 4, 136, dtype=torch.bfloat16)
    q = buf[..., 1:129].transpose(1, 2)
    k = buf[:, :, :2, :128].transpose(1, 2)
    before = ops.launch_counts()["flash_attention"]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(q, k, k)
    assert ops.launch_counts()["flash_attention"] == before


@pytest.mark.parametrize("hd,group,q_len,window,softcap,dtype", [
    (12, 3, 1, 0, None, torch.float32),
    (16, 2, 3, 0, None, torch.float32),
    (16, 3, 1, 8, 3.0, torch.float32),
    (128, 7, 1, 0, None, torch.bfloat16),
    (128, 6, 3, 5, None, torch.float32),
])
def test_decode_attention_kernel_matches_plain(card, hd, group, q_len,
                                               window, softcap, dtype):
    """Each case through ``ops`` on the route ``route`` names: the mma
    route (bf16 at hd 128) held to its bound, the CUDA-core route to
    ``TOL``; an mma case also runs the CUDA-core kernel, held to ``TOL``."""
    from repro_torch.kernels import decode_attention as DA
    s, kh = 300, 2
    q = _randn(card, 4, q_len, kh * group, hd, dtype=dtype)
    k = _randn(card, 4, s, kh, hd, dtype=dtype)
    v = _randn(card, 4, s, kh, hd, dtype=dtype)
    lens = torch.tensor([0, 1, 150, s], dtype=torch.int32, device="cuda")
    got = ops.multi_decode_attention(q, k, v, lens, window=window,
                                     softcap=softcap)
    want = ref.multi_decode_attention(q, k, v, lens, window=window,
                                      softcap=softcap)
    if DA.route(dtype, hd) == "mma":
        _within_mma_decode_bound(got, q, k, v, lens, window=window,
                                 softcap=softcap)
        rows = ops._chunk_to_rows(q, kh)
        cc = DA.launch_cuda_cores(rows, k.transpose(1, 2), v.transpose(1, 2),
                                  lens, window=window, softcap=softcap,
                                  q_len=q_len)
        _close(ops._rows_to_chunk(cc, q_len, kh * group), want, TOL[dtype])
    else:
        _close(got, want, TOL[dtype])
    assert float(got[0].abs().max()) == 0.0


def _paged_case(gen, b, kh, group, hd, page, width, lens, q_len, dtype):
    """Pools with a NaN trash page 0 (for the kernel; zero for the plain
    version), a shared prefix (pages 1..4) in every row, private pages
    after, trash entries past each row's length."""
    need = [-(-n // page) for n in lens]
    n_pages = 5 + sum(max(n - 4, 0) for n in need)
    table = torch.zeros((b, width), dtype=torch.int32)
    nxt = 5
    for r, n in enumerate(need):
        for j in range(n):
            table[r, j] = 1 + j if j < 4 else nxt
            nxt += j >= 4
    kp = _randn(gen, n_pages, page, kh, hd, dtype=dtype)
    vp = _randn(gen, n_pages, page, kh, hd, dtype=dtype)
    kp[0], vp[0] = 0, 0
    kn, vn = kp.clone(), vp.clone()
    kn[0], vn[0] = float("nan"), float("nan")
    q = _randn(gen, b, q_len, kh * group, hd, dtype=dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, kn, vn, table.cuda(), lens


@pytest.mark.parametrize("hd,group,q_len,page,window,softcap,dtype", [
    (16, 2, 1, 1, 0, None, torch.float32),
    (12, 3, 3, 4, 0, None, torch.float32),
    (16, 3, 5, 8, 5, 2.5, torch.float32),
    (128, 6, 1, 8, 0, None, torch.bfloat16),
    (128, 7, 5, 8, 0, None, torch.bfloat16),      # 35 rows: 8 warps
    (64, 7, 9, 16, 0, None, torch.float32),       # 63 rows
])
def test_paged_decode_kernel_matches_plain(card, hd, group, q_len, page,
                                           window, softcap, dtype):
    """Each case through ``ops`` on the route ``route`` names: the mma
    route (bf16 at hd 128) held to its bound, the CUDA-core route to
    ``TOL``; the launch counted under the kernel's name either way.  An
    mma case also runs the CUDA-core kernel, held to ``TOL``."""
    from repro_torch.kernels import paged_decode_attention as PDA
    from repro_torch.kernels.decode_attention import route
    lens = [0, 1, 2, 77, 150, 203]
    q, kp, vp, kn, vn, table, lens_t = _paged_case(
        card, len(lens), 2, group, hd, page, -(-210 // page), lens, q_len,
        dtype)
    before = ops.launch_counts()["paged_decode_attention"]
    got = ops.paged_multi_decode_attention(q, kn, vn, table, lens_t,
                                           window=window, softcap=softcap)
    assert ops.launch_counts()["paged_decode_attention"] == before + 1
    want = ref.paged_multi_decode_attention(q, kp, vp, table, lens_t,
                                            window=window, softcap=softcap)
    mma = route(dtype, hd) == "mma"

    def held(got, q, want):
        if mma:
            _within_mma_decode_bound(
                got, q, ref.gather_pages(kp, table),
                ref.gather_pages(vp, table), lens_t, window=window,
                softcap=softcap)
        else:
            _close(got, want, TOL[dtype])

    held(got, q, want)
    assert float(got[0].abs().max()) == 0.0
    if mma:
        cc = PDA.launch_cuda_cores(ops._chunk_to_rows(q, 2),
                                   kn.transpose(1, 2), vn.transpose(1, 2),
                                   table, lens_t, window=window,
                                   softcap=softcap, q_len=q_len)
        _close(ops._rows_to_chunk(cc, q_len, 2 * group), want, TOL[dtype])
    if q_len == 1:
        got1 = ops.paged_decode_attention(q[:, 0], kn, vn, table, lens_t,
                                          window=window, softcap=softcap)
        held(got1[:, None], q, want)


def _within_mma_decode_bound(got, q, k, v, lens, **kw):
    """The tensor-core decode route rounds p to bf16 before PV: held to
    flash's bound, 1e-5 + 2^-6·|want| + 2^-8·A, A = attention(q, k, |v|) in
    f32.  q (B, T, H, hd); k, v (B, S, KH, hd) dense (pools gathered)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    want = ref.multi_decode_attention(qf, kf, vf, lens, **kw)
    a = ref.multi_decode_attention(qf, kf, vf.abs(), lens, **kw)
    bound = 1e-5 + 2.0 ** -6 * want.abs() + 2.0 ** -8 * a
    diff = (got.float() - want).abs()
    assert bool((diff <= bound).all()), float(diff.max())   # NaN fails


def _nan_past(k, lens):
    """A copy of the dense cache k (B, S, KH, hd) that is NaN past each
    row's length: a read past it would show."""
    kn = k.clone()
    kn[torch.arange(k.shape[1], device=k.device)[None, :]
       >= lens[:, None]] = float("nan")
    return kn


@pytest.mark.parametrize("b,kh,group,s,lens", [
    (1, 2, 6, 1026, [1026]),                  # the 2B decode step
    (1, 4, 7, 2049, [2049]),                  # the 7B's
])
def test_decode_mma_route_at_the_path_shapes(card, b, kh, group, s, lens):
    """Dense decode in bf16 at hd 128 takes the tensor cores: one launch on
    the mma key, none on the CUDA cores, within the bound."""
    q = _randn(card, b, kh * group, 128, dtype=torch.bfloat16)
    k = _randn(card, b, s, kh, 128, dtype=torch.bfloat16)
    v = _randn(card, b, s, kh, 128, dtype=torch.bfloat16)
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = ops.launch_counts()
    got = ops.decode_attention(q, k, v, lens)
    after = ops.launch_counts()
    assert after["decode_attention_mma"] == before["decode_attention_mma"] + 1
    assert after["decode_attention"] == before["decode_attention"] + 1
    _within_mma_decode_bound(got[:, None], q[:, None], k, v, lens)


@pytest.mark.parametrize("hd,group,q_len,window,softcap", [
    (128, 7, 1, 0, None), (64, 1, 1, 37, None), (128, 6, 3, 0, 30.0),
    (64, 7, 10, 37, 30.0), (128, 2, 4, 0, None), (64, 5, 2, 0, 30.0),
    (128, 3, 7, 37, None), (128, 4, 9, 0, None)])
def test_decode_mma_route_sweep(card, hd, group, q_len, window, softcap):
    """cache_len 0, 1, a partial tile and the whole cache; the cache past
    each row's length NaN; q_len up to 10 (70 rows: two row tiles)."""
    s, kh = 300, 2
    q = _randn(card, 4, q_len, kh * group, hd, dtype=torch.bfloat16)
    k = _randn(card, 4, s, kh, hd, dtype=torch.bfloat16)
    v = _randn(card, 4, s, kh, hd, dtype=torch.bfloat16)
    lens = torch.tensor([0, 1, 100, s], dtype=torch.int32, device="cuda")
    got = ops.multi_decode_attention(q, _nan_past(k, lens), _nan_past(v, lens),
                                     lens, window=window, softcap=softcap)
    _within_mma_decode_bound(got, q, k, v, lens, window=window,
                             softcap=softcap)
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("hd,dtype", [(128, torch.bfloat16),
                                      (16, torch.float32)])
def test_dense_decode_takes_35_rows_on_either_route(card, hd, dtype):
    """The 7B's dense verify at γ 4 (q_len 5 × group 7 = 35 rows) runs on
    both routes: row tiles past one block's rows (32 on the CUDA cores)."""
    from repro_torch.kernels.decode_attention import route
    s, kh, group, q_len = 300, 2, 7, 5
    q = _randn(card, 3, q_len, kh * group, hd, dtype=dtype)
    k = _randn(card, 3, s, kh, hd, dtype=dtype)
    v = _randn(card, 3, s, kh, hd, dtype=dtype)
    lens = torch.tensor([3, 150, s], dtype=torch.int32, device="cuda")
    key = ("decode_attention_mma" if route(dtype, hd) == "mma"
           else "decode_attention")
    before = ops.launch_counts()[key]
    got = ops.multi_decode_attention(q, k, v, lens)
    assert ops.launch_counts()[key] == before + 1
    if dtype == torch.bfloat16:
        _within_mma_decode_bound(got, q, k, v, lens)
    else:
        _close(got, ref.multi_decode_attention(q, k, v, lens), TOL[dtype])


@pytest.mark.parametrize("tag,b,kh,group,q_len", [
    ("a", 8, 2, 6, 1), ("b", 8, 4, 7, 1), ("c", 4, 4, 7, 5)])
def test_paged_decode_mma_route_at_the_path_shapes(card, tag, b, kh, group,
                                                   q_len):
    """The slot path's shapes (page 8, table width 257, cache_len
    1025..2049, NaN trash page) on the tensor cores, within the bound."""
    lens = [1025 + (1024 * i) // (b - 1) for i in range(b)]
    q, kp, vp, kn, vn, table, lens_t = _paged_case(
        card, b, kh, group, 128, 8, 257, lens, q_len, torch.bfloat16)
    before = ops.launch_counts()["paged_decode_attention_mma"]
    got = ops.paged_multi_decode_attention(q, kn, vn, table, lens_t)
    assert ops.launch_counts()["paged_decode_attention_mma"] == before + 1
    _within_mma_decode_bound(got, q, ref.gather_pages(kp, table),
                             ref.gather_pages(vp, table), lens_t)


@pytest.mark.parametrize("hd,group,q_len,page,window,softcap", [
    (128, 7, 1, 8, 0, None), (64, 2, 3, 64, 50, None),
    (128, 6, 5, 64, 0, 30.0), (64, 7, 10, 8, 50, 30.0),
    (128, 1, 1, 1, 0, None), (64, 4, 7, 16, 0, None)])
def test_paged_decode_mma_route_sweep(card, hd, group, q_len, page, window,
                                      softcap):
    """Idle rows, rows shorter than the chunk, partial and whole tiles;
    pages of 1-64 slots; the NaN trash page never read."""
    lens = [0, 1, 2, 77, 150, 203]
    q, kp, vp, kn, vn, table, lens_t = _paged_case(
        card, len(lens), 2, group, hd, page, -(-210 // page), lens, q_len,
        torch.bfloat16)
    got = ops.paged_multi_decode_attention(q, kn, vn, table, lens_t,
                                           window=window, softcap=softcap)
    _within_mma_decode_bound(got, q, ref.gather_pages(kp, table),
                             ref.gather_pages(vp, table), lens_t,
                             window=window, softcap=softcap)
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("hd,dtype", [(128, torch.bfloat16),
                                      (16, torch.float32)])
def test_paged_verify_takes_70_rows_on_either_route(card, hd, dtype):
    """The 7B verifier at γ 9: q_len 10 × group 7 = 70 rows, past one
    block's 64, on both routes (two row tiles)."""
    from repro_torch.kernels.decode_attention import route
    lens = [9, 500, 1025, 2049]
    q, kp, vp, kn, vn, table, lens_t = _paged_case(
        card, 4, 4, 7, hd, 8, 257, lens, 10, dtype)
    key = ("paged_decode_attention_mma" if route(dtype, hd) == "mma"
           else "paged_decode_attention")
    before = ops.launch_counts()[key]
    got = ops.paged_multi_decode_attention(q, kn, vn, table, lens_t)
    assert ops.launch_counts()[key] == before + 1
    if dtype == torch.bfloat16:
        _within_mma_decode_bound(got, q, ref.gather_pages(kp, table),
                                 ref.gather_pages(vp, table), lens_t)
    else:
        _close(got, ref.paged_multi_decode_attention(q, kp, vp, table,
                                                     lens_t), TOL[dtype])


def test_decode_mma_route_refuses_misaligned_views(card):
    """cp.async's 16-byte rule is checked before the launch: a misaligned
    view raises on both entries, it never takes the CUDA-core route."""
    buf = _randn(card, 1, 2, 8, 136, dtype=torch.bfloat16)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        decode_attention_cuda(buf[..., 1:129], buf[..., :128],
                              buf[..., :128], 3)
    pool = _randn(card, 4, 2, 8, 136, dtype=torch.bfloat16)
    table = torch.zeros((1, 3), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        paged_decode_attention_cuda(buf[..., :128], pool[..., 1:129],
                                    pool[..., :128], table, 3)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("hd,group,q_len,q_blk,page,window,softcap,dtype", [
    (16, 2, 1, None, 1, 0, None, torch.float32),
    (16, 6, 64, 8, 2, 24, None, torch.float32),     # 384 rows, 8 sub-blocks
    (12, 7, 16, 3, 8, 0, 2.5, torch.float32),       # 16 % 3: a short tail
    (64, 1, 6, 4, 16, 0, None, torch.float32),
    (128, 6, 256, None, 8, 0, None, torch.bfloat16),  # a 2B region chunk
])
def test_paged_prefill_kernel_matches_plain(card, hd, group, q_len, q_blk,
                                            page, window, softcap, dtype):
    """Rows: idle, shorter than the chunk, the chunk alone, mid-prefill and
    longer; NaN trash page; the pools are left as they were.  Through
    ``ops`` on the route ``route`` names: the mma route (bf16 at hd 128)
    held to its bound, the CUDA-core route to ``TOL``; the launch counted
    under the kernel's name either way.  An mma case also runs the
    CUDA-core kernel, held to ``TOL``."""
    from repro_torch.kernels import paged_prefill_attention as PPA
    from repro_torch.kernels.decode_attention import route
    lens = [0, max(q_len - 1, 1), q_len, q_len + 77, q_len + 203]
    q, kp, vp, kn, vn, table, lens_t = _paged_case(
        card, len(lens), 2, group, hd, page, -(-(q_len + 210) // page),
        lens, q_len, dtype)
    before = ops.launch_counts()["paged_prefill_attention"]
    kn0 = kn.clone()
    got = ops.paged_prefill_attention(q, kn, vn, table, lens_t,
                                      window=window, softcap=softcap,
                                      q_blk=q_blk)
    assert ops.launch_counts()["paged_prefill_attention"] == before + 1
    want = ref.paged_prefill_attention(q, kp, vp, table, lens_t,
                                       window=window, softcap=softcap)
    if route(dtype, hd) == "mma":
        _within_mma_decode_bound(got, q, ref.gather_pages(kp, table),
                                 ref.gather_pages(vp, table), lens_t,
                                 window=window, softcap=softcap)
        cc = PPA.launch_cuda_cores(ops._chunk_to_rows(q, 2),
                                   kn.transpose(1, 2), vn.transpose(1, 2),
                                   table, lens_t, window=window,
                                   softcap=softcap, q_len=q_len, q_blk=q_blk)
        _close(ops._rows_to_chunk(cc, q_len, 2 * group), want, TOL[dtype])
    else:
        _close(got, want, TOL[dtype])
    assert float(got[0].abs().max()) == 0.0
    assert torch.equal(kn.nan_to_num(), kn0.nan_to_num())


def _flat_case(gen, runs, *, tb, n_slots, kh, group, hd, page, width,
               shared, scene_of):
    """One fused step at the engine's flat shape, bf16: ``runs`` are
    (slot, first position, tokens) in flat order, the rest of the ``tb``
    rows padding (the last slot's table row, position 0).  Each slot's
    table maps its scene's ``shared`` prefix pages, then private pages, up
    to the page of its last position in the step, and its entries past
    that page 0, the trash page (NaN in the kernel's pools, zero in the
    plain version's), so a read past a row's length shows.  Returns (q,
    kp, vp, kn, vn, table, lens, plan on the card, the covered rows)."""
    from repro_torch.kernels import paged_prefill_attention as PPA
    srow = np.full((tb,), n_slots, np.int32)
    pos = np.zeros((tb,), np.int32)
    j = 0
    for slot, p0, n in runs:
        srow[j:j + n], pos[j:j + n] = slot, p0 + np.arange(n)
        j += n
    n_scenes = max(scene_of) + 1
    tables = np.zeros((n_slots, width), np.int32)
    nxt = 1 + n_scenes * shared
    for sl in range(n_slots):
        tables[sl, :shared] = 1 + scene_of[sl] * shared + np.arange(shared)
        tables[sl, shared:] = nxt + np.arange(width - shared)
        nxt += width - shared
    rows_slot = np.minimum(srow, n_slots - 1)
    need = np.zeros((n_slots,), np.int64)       # entries below a length
    np.maximum.at(need, rows_slot, -(-(pos + 1) // page))
    tables[np.arange(width)[None, :] >= need[:, None]] = 0
    kp = _randn(gen, nxt, page, kh, hd, dtype=torch.bfloat16)
    vp = _randn(gen, nxt, page, kh, hd, dtype=torch.bfloat16)
    kp[0], vp[0] = 0, 0
    kn, vn = kp.clone(), vp.clone()
    kn[0], vn[0] = float("nan"), float("nan")
    q = _randn(gen, tb, 1, kh * group, hd, dtype=torch.bfloat16)
    table = torch.from_numpy(tables[rows_slot]).cuda()
    lens = torch.from_numpy(pos + 1).cuda()
    plan = PPA.tile_plan(srow, pos, n_slots, group,
                         PPA.plan_tiles(tb, n_slots, group))
    return (q, kp, vp, kn, vn, table, lens, torch.from_numpy(plan).cuda(),
            torch.from_numpy(srow < n_slots).cuda())


def _held_rows(got, q, kp, vp, table, lens, rows, **kw):
    _within_mma_decode_bound(got[rows], q[rows],
                             ref.gather_pages(kp, table[rows]),
                             ref.gather_pages(vp, table[rows]), lens[rows],
                             **kw)


#: (d) the 2B engine's flat fused step: 8 decode rows over two scenes'
#: shared prefixes, then a third scene's last 256-token chunk as 256 rows
#: of its streaming slot; (e) that chunk as one q_len-256 row
PATH_DECODE = [(i, 1024 + (1024 * i) // 7, 1) for i in range(8)]


@pytest.mark.parametrize("plan", [True, False])
def test_prefill_mma_route_at_the_flat_path_shape(card, plan):
    """(d), with and without the tile plan: every scheduled row within the
    route's bound; the pools unchanged; one launch on the mma route."""
    q, kp, vp, kn, vn, table, lens, tiles, rows = _flat_case(
        card, PATH_DECODE + [(8, 768, 256)], tb=264, n_slots=9, kh=2,
        group=6, hd=128, page=8, width=257, shared=128,
        scene_of=[0, 1] * 4 + [2])
    kn0 = kn.clone()
    before = ops.launch_counts()["paged_prefill_attention_mma"]
    got = ops.paged_prefill_attention(q, kn, vn, table, lens,
                                      plan=tiles if plan else None)
    assert ops.launch_counts()["paged_prefill_attention_mma"] == before + 1
    assert bool(rows.all())
    _held_rows(got, q, kp, vp, table, lens, rows)
    assert torch.equal(kn.nan_to_num(), kn0.nan_to_num())


def test_prefill_mma_route_at_the_chunk_path_shape(card):
    """(e): the 2B's 256-token chunk as one q_len-256 row at cache_len
    1024, 26 row tiles of 10 tokens, each walking only its own keys."""
    q, kp, vp, kn, vn, table, lens = _paged_case(
        card, 1, 2, 6, 128, 8, 257, [1024], 256, torch.bfloat16)
    got = ops.paged_prefill_attention(q, kn, vn, table, lens)
    _within_mma_decode_bound(got, q, ref.gather_pages(kp, table),
                             ref.gather_pages(vp, table), lens)


@pytest.mark.parametrize("hd,group,q_len,page,window,softcap", [
    (64, 1, 1, 1, 0, None), (128, 6, 7, 2, 24, None),
    (64, 7, 16, 4, 0, 30.0), (128, 6, 64, 8, 0, None),
    (128, 7, 100, 16, 40, 30.0), (64, 1, 256, 8, 0, None),
    (128, 6, 256, 16, 100, None), (128, 7, 33, 4, 0, 5.0)])
def test_prefill_mma_route_sweep(card, hd, group, q_len, page, window,
                                 softcap):
    """Page sizes 1-16, chunks of 1-256 tokens, groups 1/6/7, windows and
    softcaps; rows idle, shorter than the chunk, the chunk alone and
    mid-prefill over shared prefix pages; NaN trash page; the pools left
    as they were."""
    lens = [0, max(q_len - 1, 1), q_len, q_len + 37, q_len + 150, 3]
    q, kp, vp, kn, vn, table, lens_t = _paged_case(
        card, len(lens), 2, group, hd, page, -(-(q_len + 160) // page),
        lens, q_len, torch.bfloat16)
    kn0, vn0 = kn.clone(), vn.clone()
    kw = dict(window=window, softcap=softcap)
    got = ops.paged_prefill_attention(q, kn, vn, table, lens_t, **kw)
    _within_mma_decode_bound(got, q, ref.gather_pages(kp, table),
                             ref.gather_pages(vp, table), lens_t, **kw)
    assert float(got[0].abs().max()) == 0.0
    assert torch.equal(kn.nan_to_num(), kn0.nan_to_num())
    assert torch.equal(vn.nan_to_num(), vn0.nan_to_num())


@pytest.mark.parametrize("hd,group,window,softcap", [
    (128, 6, 0, None), (64, 7, 40, 30.0), (128, 1, 0, None)])
def test_prefill_mma_route_with_a_mixed_plan(card, hd, group, window,
                                             softcap):
    """A step of decode rows, a prompt row, a fresh stream and one
    mid-prefill, then padding: every scheduled row within the bound with
    the plan, every row without it; an idle step's plan (every entry
    empty) launches and exits cleanly."""
    from repro_torch.kernels import paged_prefill_attention as PPA
    runs = [(0, 300, 1), (1, 150, 1), (2, 64, 1), (3, 0, 23), (4, 40, 50)]
    q, kp, vp, kn, vn, table, lens, tiles, rows = _flat_case(
        card, runs, tb=90, n_slots=5, kh=2, group=group, hd=hd, page=8,
        width=48, shared=8, scene_of=[0, 0, 1, 2, 1])
    kw = dict(window=window, softcap=softcap)
    got = ops.paged_prefill_attention(q, kn, vn, table, lens, plan=tiles,
                                      **kw)
    _held_rows(got, q, kp, vp, table, lens, rows, **kw)
    got = ops.paged_prefill_attention(q, kn, vn, table, lens, **kw)
    _held_rows(got, q, kp, vp, table, lens, torch.ones_like(rows), **kw)
    before = ops.launch_counts()["paged_prefill_attention_mma"]
    PPA.launch_mma(ops._chunk_to_rows(q, 2), kn.transpose(1, 2),
                   vn.transpose(1, 2), table, lens,
                   plan=torch.zeros_like(tiles), **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_prefill_attention_mma"] == before + 1


def test_prefill_mma_route_refuses_what_it_does_not_take(card):
    """cp.async's 16-byte rule and the plan's form are checked before the
    launch: a misaligned view, a plan with q_len > 1 and a plan of the
    wrong dtype raise, and nothing launches."""
    from repro_torch.kernels import paged_prefill_attention as PPA
    buf = _randn(card, 1, 2, 8, 136, dtype=torch.bfloat16)
    pool = _randn(card, 4, 2, 8, 136, dtype=torch.bfloat16)
    table = torch.zeros((1, 3), dtype=torch.int32, device="cuda")
    plan = torch.tensor([[0], [1]], dtype=torch.int32, device="cuda")
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        paged_prefill_attention_cuda(buf[..., 1:129], pool[..., :128],
                                     pool[..., :128], table, 3)
    with pytest.raises(ValueError, match="16-byte"):
        paged_prefill_attention_cuda(buf[..., :128], pool[..., 1:129],
                                     pool[..., :128], table, 3)
    with pytest.raises(ValueError, match="q_len 1"):
        PPA.launch_mma(buf[..., :128], pool[..., :128], pool[..., :128],
                       table, 3, q_len=2, plan=plan)
    with pytest.raises(ValueError, match="tile plan"):
        PPA.launch_mma(buf[..., :128], pool[..., :128], pool[..., :128],
                       table, 3, plan=plan.long())
    assert ops.launch_counts() == before


def _quant_case(gen, kind, b, kh, group, hd, page, width, lens, q_len,
                dtype):
    """``_paged_case``'s pools quantized to ``kind``: (q, clean pools,
    trash pools), each a {"k", "v", "k_scale", "v_scale"} dict.  The trash
    page of the kernel's pools has NaN scales (an int8 page cannot hold
    NaN) and, in fp8, NaN bytes (0x7F), so a read past a row's length
    shows; the plain version's has the quantized zero page."""
    from repro_torch.kernels import kv_quant
    q, kp, vp, _, _, table, lens_t = _paged_case(
        gen, b, kh, group, hd, page, width, lens, q_len, torch.float32)
    pools = kv_quant.quantize_pool(kp, vp, kind)
    nan = {k: v.clone() for k, v in pools.items()}
    nan["k_scale"][0] = nan["v_scale"][0] = float("nan")
    if kind == "fp8":
        nan["k"].view(torch.uint8)[0] = 0x7F
        nan["v"].view(torch.uint8)[0] = 0x7F
    return q.to(dtype), pools, nan, table, lens_t


def _scales(pools):
    return {"k_scale": pools["k_scale"], "v_scale": pools["v_scale"]}


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("op,hd,group,q_len,page,window,dtype", [
    ("decode", 16, 3, 1, 4, 0, torch.float32),
    ("decode", 128, 6, 1, 8, 0, torch.float32),
    ("decode", 128, 6, 1, 8, 0, torch.bfloat16),    # mma
    ("decode", 64, 7, 5, 1, 40, torch.bfloat16),    # mma verify, window
    ("decode", 128, 7, 10, 8, 0, torch.bfloat16),   # 70 rows: two tiles
    ("prefill", 12, 7, 16, 8, 0, torch.float32),
    ("prefill", 32, 6, 9, 4, 24, torch.float32),    # 8-bit rows at HD 32
    ("prefill", 128, 6, 64, 8, 0, torch.bfloat16),  # mma prefix-append
])
def test_quantized_paged_kernels_match_plain(card, kind, op, hd, group,
                                             q_len, page, window, dtype):
    """The paged kernels read an 8-bit pool and its scales themselves: held
    on the route ``route`` names to the dequantized plain version (the mma
    route to its bound), the trash page's NaN scales never read, the pools
    left as they were, the launch counted under the pool's storage."""
    from repro_torch.kernels.decode_attention import route
    lens = [0, max(q_len - 1, 1), q_len, q_len + 77, q_len + 150]
    q, pools, nan, table, lens_t = _quant_case(
        card, kind, len(lens), 2, group, hd, page, -(-(q_len + 160) // page),
        lens, q_len, dtype)
    nan0 = {k: v.clone() for k, v in nan.items()}
    name = ("paged_decode_attention" if op == "decode"
            else "paged_prefill_attention")
    fn = (ops.paged_multi_decode_attention if op == "decode"
          else ops.paged_prefill_attention)
    before = ops.launch_counts()
    got = fn(q, nan["k"], nan["v"], table, lens_t, window=window,
             **_scales(nan))
    after = ops.launch_counts()
    assert after[f"{name}[{kind}]"] == before[f"{name}[{kind}]"] + 1
    assert after[name] == before[name] + 1
    want = ref.paged_multi_decode_attention(q.float(), pools["k"],
                                            pools["v"], table, lens_t,
                                            window=window, **_scales(pools))
    if route(dtype, hd) == "mma":
        kd = ref.gather_pages(ref.dequantize_pool(pools["k"],
                                                  pools["k_scale"]), table)
        vd = ref.gather_pages(ref.dequantize_pool(pools["v"],
                                                  pools["v_scale"]), table)
        _within_mma_decode_bound(got, q, kd, vd, lens_t, window=window)
        assert after[f"{name}_mma[{kind}]"] == \
            before[f"{name}_mma[{kind}]"] + 1
    else:
        _close(got, want, TOL[dtype])
    assert float(got[0].abs().max()) == 0.0
    for k in nan:
        assert torch.equal(nan[k].view(torch.uint8) if k in ("k", "v")
                           else nan[k].nan_to_num(),
                           nan0[k].view(torch.uint8) if k in ("k", "v")
                           else nan0[k].nan_to_num())
    if q_len == 1:
        got1 = ops.paged_decode_attention(q[:, 0], nan["k"], nan["v"],
                                          table, lens_t, window=window,
                                          **_scales(nan))
        assert torch.equal(got1, got[:, 0])


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("plan", [True, False])
def test_quantized_prefill_mma_route_at_the_flat_path_shape(card, kind,
                                                            plan):
    """(d) on an 8-bit pool, with and without the tile plan: every
    scheduled row within the route's bound of the dequantized plain
    version; the trash page (NaN scales) never read."""
    from repro_torch.kernels import kv_quant
    q, kp, vp, _, _, table, lens, tiles, rows = _flat_case(
        card, PATH_DECODE + [(8, 768, 256)], tb=264, n_slots=9, kh=2,
        group=6, hd=128, page=8, width=257, shared=128,
        scene_of=[0, 1] * 4 + [2])
    pools = kv_quant.quantize_pool(kp.float(), vp.float(), kind)
    nan = {k: v.clone() for k, v in pools.items()}
    nan["k_scale"][0] = nan["v_scale"][0] = float("nan")
    got = ops.paged_prefill_attention(q, nan["k"], nan["v"], table, lens,
                                      plan=tiles if plan else None,
                                      **_scales(nan))
    kd = ref.dequantize_pool(pools["k"], pools["k_scale"])
    vd = ref.dequantize_pool(pools["v"], pools["v_scale"])
    _held_rows(got, q, kd, vd, table, lens, rows)


def test_quantized_wrappers_refuse_what_the_kernels_do_not_take(card):
    """An 8-bit pool without both scales, scales of the wrong dtype or
    shape, mixed pools, and scales beside an fp pool raise before any
    launch."""
    from repro_torch.kernels import kv_quant
    q, pools, _, table, lens = _quant_case(card, "int8", 2, 2, 3, 16, 4, 8,
                                           [3, 9], 1, torch.float32)
    k, v, ks, vs = pools["k"], pools["v"], pools["k_scale"], pools["v_scale"]
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="together"):
        ops.paged_decode_attention(q[:, 0], k, v, table, lens, k_scale=ks)
    with pytest.raises(ValueError, match="needs k_scale"):
        paged_decode_attention_cuda(ops._chunk_to_rows(q, 2),
                                    k.transpose(1, 2), v.transpose(1, 2),
                                    table, lens)
    with pytest.raises(ValueError, match="float32"):
        ops.paged_decode_attention(q[:, 0], k, v, table, lens,
                                   k_scale=ks.double(), v_scale=vs)
    with pytest.raises(ValueError, match="float32"):
        ops.paged_decode_attention(q[:, 0], k, v, table, lens,
                                   k_scale=ks[:, :2], v_scale=vs[:, :2])
    with pytest.raises(ValueError, match="share their dtype"):
        ops.paged_decode_attention(
            q[:, 0], k, kv_quant.quantize_pool(v.float(), v.float(),
                                               "fp8")["v"],
            table, lens, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="no scales"):
        ops.paged_prefill_attention(q, ks.new_zeros(k.shape), ks.new_zeros(
            k.shape), table, lens, k_scale=ks, v_scale=vs)
    assert ops.launch_counts() == before


#: gemma3-1b's local-layer window, biting at the lengths below
HD256_WINDOW = 512


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row,pool,group", [
    ("flash", "fp", 4), ("flash", "fp", 1), ("decode", "fp", 4),
    ("verify", "fp", 1), ("paged_decode", "fp", 4),
    ("paged_decode", "int8", 4), ("paged_decode", "fp8", 4),
    ("paged_verify", "fp", 1), ("paged_verify", "int8", 4),
    ("prefix_append", "fp", 4), ("prefix_append", "int8", 4),
    ("prefix_append", "fp8", 1)])
def test_hd256_kernels_match_plain(card, row, pool, group, dtype):
    """gemma3-1b's head dim 256: rows 1, 2 and 4-6 on their CUDA-core
    routes (bf16 takes them by its shape), on fp pools and on int8 and fp8
    pools with their scales, held to ``TOL`` against the plain version
    (8-bit pools dequantized), with the window biting, a softcap on every
    other case, rows of length 0, and a NaN trash page; every launch counted
    on the CUDA-core route, none on the tensor cores."""
    window = HD256_WINDOW
    softcap = 30.0 if group == 1 else None
    kw = {"window": window, "softcap": softcap}
    kh = 1 if group == 4 else 2
    before = ops.launch_counts()
    if row == "flash":
        q = _randn(card, 1, 700, kh * group, 256, dtype=dtype)
        k, v = (_randn(card, 1, 700, kh, 256, dtype=dtype) for _ in "kv")
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention(q, k, v, **kw)
        name = "flash_attention"
    elif row in ("decode", "verify"):
        q_len = 1 if row == "decode" else 3
        q = _randn(card, 4, q_len, kh * group, 256, dtype=dtype)
        k, v = (_randn(card, 4, 800, kh, 256, dtype=dtype) for _ in "kv")
        lens = torch.tensor([0, 1, 650, 800], dtype=torch.int32,
                            device="cuda")
        got = ops.multi_decode_attention(q, _nan_past(k, lens),
                                         _nan_past(v, lens), lens, **kw)
        want = ref.multi_decode_attention(q, k, v, lens, **kw)
        name = "decode_attention"
    else:
        q_len = {"paged_decode": 1, "paged_verify": 5,
                 "prefix_append": 16}[row]
        lens = [0, max(q_len - 1, 1), q_len, q_len + 77, q_len + 700]
        width = -(-(q_len + 710) // 8)
        if pool == "fp":
            q, kp, vp, kn, vn, table, lens_t = _paged_case(
                card, len(lens), kh, group, 256, 8, width, lens, q_len,
                dtype)
            pools, nan = {"k": kp, "v": vp}, {"k": kn, "v": vn}
            sc, want_sc = {}, {}
        else:
            q, pools, nan, table, lens_t = _quant_case(
                card, pool, len(lens), kh, group, 256, 8, width, lens,
                q_len, dtype)
            sc, want_sc = _scales(nan), _scales(pools)
        if row == "prefix_append":
            got = ops.paged_prefill_attention(q, nan["k"], nan["v"], table,
                                              lens_t, q_blk=3, **kw, **sc)
            name = "paged_prefill_attention"
        else:
            got = ops.paged_multi_decode_attention(q, nan["k"], nan["v"],
                                                   table, lens_t, **kw, **sc)
            name = "paged_decode_attention"
        want = ref.paged_multi_decode_attention(q, pools["k"], pools["v"],
                                                table, lens_t, **kw,
                                                **want_sc)
    after = ops.launch_counts()
    _close(got, want, TOL[dtype])
    if row != "flash":
        assert float(got[0].abs().max()) == 0.0
    second = ops.ROUTES[name][0]
    assert after[name] == before[name] + 1
    assert after[second] == before[second]
    if pool != "fp":
        assert after[f"{name}[{pool}]"] == before[f"{name}[{pool}]"] + 1


@pytest.mark.parametrize("b,r,nv,ne,d,dtype", [
    (2, 100, 1, 1, 1536, torch.bfloat16),
    (2, 100, 3, 2, 48, torch.float32),
    (1, 1024, 1, 1, 1536, torch.bfloat16),     # the main path's shape
    (1, 1023, 1, 1, 1536, torch.bfloat16),     # a partial last block
    (2, 100, 3, 5, 300, torch.bfloat16),       # scalar path: 300 % 8
    (2, 100, 3, 5, 301, torch.float32),        # scalar path: odd D
    (1, 64, 1, 1, 3584, torch.bfloat16),       # the 7B width: two pieces
    (2, 37, 3, 5, 3584, torch.bfloat16),       # six pieces over three rows
    (2, 100, 3, 5, 1536, torch.bfloat16),      # Nv 3, Ne 5
    (1, 50, 2, 3, 2100, torch.float32),        # three pieces a row, f32
    (1, 8, 2, 2, 9000, torch.bfloat16),        # five pieces a row
    (1, 20, 3, 1, 1, torch.float32),           # D 1
])
def test_region_score_kernel_matches_plain(card, b, r, nv, ne, d, dtype):
    v = _randn(card, b, r, nv, d, dtype=dtype)
    e = _randn(card, b, ne, d, dtype=dtype)
    _close(ops.region_score(v, e), ref.region_score(v, e), TOL_REGION)


def test_region_score_kernel_takes_views_and_wide_grids(card):
    """The offload path's (B, R, 1, D) view of (B, R, D) features, an
    unaligned base (the scalar path), B 70000 past the old 65535 grid cap,
    and D at the shared-memory limit."""
    from repro_torch.kernels.region_score import (MAX_SMEM_FLOATS,
                                                  region_score_cuda)
    feats = _randn(card, 2, 1024, 1536, dtype=torch.bfloat16)
    text = _randn(card, 2, 1, 1536, dtype=torch.bfloat16)
    view = feats[:, :, None, :]
    _close(region_score_cuda(view, text), ref.region_score(view, text),
           TOL_REGION)
    buf = _randn(card, 2, 100, 2, 1537, dtype=torch.bfloat16)
    e = _randn(card, 2, 3, 1536, dtype=torch.bfloat16)
    _close(region_score_cuda(buf[..., 1:], e),
           ref.region_score(buf[..., 1:], e), TOL_REGION)
    v, e = _randn(card, 70000, 1, 1, 8), _randn(card, 70000, 1, 8)
    _close(region_score_cuda(v, e), ref.region_score(v, e), TOL_REGION)
    d = MAX_SMEM_FLOATS - 2
    v, e = _randn(card, 1, 9, 1, d), _randn(card, 1, 2, d)
    _close(region_score_cuda(v, e), ref.region_score(v, e), TOL_REGION)


def test_region_score_refuses_past_shared_memory(card):
    from repro_torch.kernels.region_score import (MAX_SMEM_FLOATS,
                                                  region_score_cuda)
    before = ops.launch_counts()
    d = MAX_SMEM_FLOATS - 1
    with pytest.raises(ValueError, match="shared memory"):
        region_score_cuda(_randn(card, 1, 4, 1, d), _randn(card, 1, 2, d))
    with pytest.raises(ValueError, match="shared memory"):
        region_score_cuda(_randn(card, 1, 4, 1, d + 1), _randn(card, 1, 1,
                                                               d + 1))
    assert ops.launch_counts() == before


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = _randn(card, 1, 4, 8, 16)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        flash_attention_cuda(q, q[:, :2, :4], q[:, :2, :4])
    with pytest.raises(ValueError, match="head dim"):
        x = _randn(card, 1, 2, 4, 130)
        flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="share device and dtype"):
        flash_attention_cuda(q, q.bfloat16(), q)
    pool = _randn(card, 6, 2, 8, 16)                 # (n_pages, KH, page, hd)
    table = torch.zeros((1, 3), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="block_table"):
        paged_decode_attention_cuda(_randn(card, 1, 2, 4, 16), pool, pool,
                                    table.long(), 3)
    with pytest.raises(ValueError, match="bad shapes"):
        paged_prefill_attention_cuda(_randn(card, 1, 2, 4, 16), pool,
                                     pool[:5], table, 3, q_len=2)
    with pytest.raises(ValueError, match="q_blk"):
        paged_prefill_attention_cuda(_randn(card, 1, 2, 12, 16), pool, pool,
                                     table, 3, q_len=2, q_blk=11)
    with pytest.raises(ValueError, match="q_blk"):
        paged_prefill_attention_cuda(_randn(card, 1, 2, 12, 16), pool, pool,
                                     table, 3, q_len=2, q_blk=0)


@pytest.mark.parametrize("s,chunk,dk,dv,carried,g,dtype", [
    (1, 64, 8, 9, False, None, torch.float32),
    (37, 64, 16, 24, True, None, torch.float32),      # chunk = S
    (256, 16, 384, 385, True, None, torch.float32),   # the xLSTM dk, dv
    (128, 64, 8, 24, True, -2.0, torch.float32),      # the oracle's NaN case
    (256, 64, 16, 9, False, -30.0, torch.float32),
    (512, 64, 384, 385, False, None, torch.bfloat16),
])
def test_ssm_scan_kernel_matches_plain(card, s, chunk, dk, dv, carried, g,
                                       dtype):
    b, h = 2, 4
    q = (_randn(card, b, s, h, dk) * dk ** -0.5).to(dtype)
    k = _randn(card, b, s, h, dk, dtype=dtype)
    v = _randn(card, b, s, h, dv, dtype=dtype)
    log_g = (-torch.nn.functional.softplus(_randn(card, b, s, h))
             if g is None else torch.full((b, s, h), g, device="cuda"))
    st = _randn(card, b, h, dk, dv) if carried else None
    before = ops.launch_counts()["ssm_scan"]
    o, sf = ops.ssm_scan(q, k, v, log_g, st, chunk=chunk)
    assert ops.launch_counts()["ssm_scan"] == before + 1
    wo, wsf = ref.ssm_scan(q, k, v, log_g, st, chunk=chunk)
    assert bool(o.isfinite().all()) and bool(sf.isfinite().all())
    _close(o, wo, TOL_SCAN[dtype])
    _close(sf, wsf, TOL_SCAN[torch.float32])


@pytest.mark.parametrize("b,s,heads,p_dim,carried", [
    (1, 1, 1, 8, False), (2, 37, 4, 64, True), (3, 300, 4, 192, True),
    (2, 1, 4, 192, True)])
def test_slstm_scan_kernel_matches_plain(card, b, s, heads, p_dim, carried):
    """Gate pre-activations ~N(0, 10²) (past ±30: the stabiliser), h and
    all four final states."""
    gx = _randn(card, b, s, 4 * heads * p_dim) * 10
    r = _randn(card, heads, p_dim, 4 * p_dim) * p_dim ** -0.5
    st = None
    if carried:
        st = (torch.tanh(_randn(card, b, heads, p_dim)),
              _randn(card, b, heads, p_dim),
              torch.rand((b, heads, p_dim), device="cuda") + 0.5,
              _randn(card, b, heads, p_dim) * 10)
    before = ops.launch_counts()["slstm_scan"]
    h, fin = ops.slstm_scan(gx, r, st)
    assert ops.launch_counts()["slstm_scan"] == before + 1
    wh, wfin = ref.slstm_scan(gx, r, st)
    _close(h, wh, TOL_SLSTM)
    for a, w in zip(fin, wfin):
        _close(a, w, TOL_SLSTM)


def _slstm_inputs(card, b, s, heads, p_dim, carried):
    gx = _randn(card, b, s, 4 * heads * p_dim) * 10
    r = _randn(card, heads, p_dim, 4 * p_dim) * p_dim ** -0.5
    st = None
    if carried:
        st = (torch.tanh(_randn(card, b, heads, p_dim)),
              _randn(card, b, heads, p_dim),
              torch.rand((b, heads, p_dim), device="cuda") + 0.5,
              _randn(card, b, heads, p_dim) * 10)
    return gx, r, st


def _slstm_close(got, want):
    _close(got[0], want[0], TOL_SLSTM)
    for a, w in zip(got[1], want[1]):
        _close(a, w, TOL_SLSTM)


@pytest.mark.parametrize("route", ["cluster", "per_row"])
@pytest.mark.parametrize("b,s,heads,p_dim,carried", [
    (1, 1, 1, 8, False), (2, 37, 4, 64, True), (3, 300, 4, 192, True),
    (2, 1, 4, 192, True), (5, 37, 2, 64, True), (3, 20, 3, 100, False),
    (1, 50, 1, 256, True), (128, 3, 4, 192, True), (4, 1, 4, 192, False)])
def test_slstm_routes_match_plain(card, route, b, s, heads, p_dim, carried):
    """Each route on any shape the wrapper takes (ragged batch groups and
    units, P 8 to 256), pre-activations ~N(0, 10²) past ±30, zero and
    carried state: h and all four final states."""
    from repro_torch.kernels import slstm_scan as SL
    gx, r, st = _slstm_inputs(card, b, s, heads, p_dim, carried)
    launch = {"cluster": SL.launch_cluster, "per_row": SL.launch_per_row}
    _slstm_close(launch[route](gx, r, st), ref.slstm_scan(gx, r, st))


@pytest.mark.parametrize("plan", [(4, 1), (2, 2), (3, 3), (5, 1), (7, 2),
                                  (16, 5), (13, 4)])
def test_slstm_cluster_plans_match_plain(card, plan):
    """The cluster kernel at plans the planner may not pick: every cluster
    size, groups of 1 to 5 rows over a ragged batch, units not dividing P."""
    from repro_torch.kernels import slstm_scan as SL
    gx, r, st = _slstm_inputs(card, 5, 9, 2, 64, True)
    _slstm_close(SL.launch_cluster(gx, r, st, plan=plan),
                 ref.slstm_scan(gx, r, st))


@pytest.mark.parametrize("b,s,heads,p_dim", [
    (4, 64, 4, 192), (128, 8, 4, 192), (4, 1, 4, 192), (128, 1, 4, 192),
    (1, 64, 1, 8), (3, 5, 4, 64), (3, 5, 4, 32)])
def test_slstm_shapes_take_the_route_the_rule_names(card, b, s, heads,
                                                    p_dim):
    """Phase 2's shapes (S cut) through ``ops``: one launch, on the route
    ``route`` names for its P; the cluster plan every cluster resident."""
    from repro_torch.kernels import slstm_scan as SL
    gx, r, st = _slstm_inputs(card, b, s, heads, p_dim, True)
    before = ops.launches_by_route(ops.launch_counts(), "slstm_scan")
    _slstm_close(ops.slstm_scan(gx, r, st), ref.slstm_scan(gx, r, st))
    after = ops.launches_by_route(ops.launch_counts(), "slstm_scan")
    rule = SL.route(p_dim)
    assert {k: after[k] - before[k] for k in after} == {
        "cluster": int(rule == "cluster"), "per_row": int(rule == "per_row")}
    assert rule == ("cluster" if p_dim >= 64 else "per_row")
    cs, bt = SL.card_cluster_plan(b, heads, p_dim, 0)
    assert heads * -(-b // bt) <= SL.max_clusters(0, p_dim, cs, bt)


@pytest.mark.parametrize("b,s,heads,p_dim", [
    (256, 9, 4, 192), (4, 33, 16, 192), (128, 5, 8, 192)])
def test_slstm_cluster_route_runs_past_one_wave(card, b, s, heads, p_dim):
    """Shapes with more clusters than the card holds at once (a large
    batch, many heads) through ``ops``: one launch on the cluster route,
    in more than one wave, h and all four final states as the plain
    version's."""
    from repro_torch.kernels import slstm_scan as SL
    gx, r, st = _slstm_inputs(card, b, s, heads, p_dim, True)
    before = ops.launches_by_route(ops.launch_counts(), "slstm_scan")
    _slstm_close(ops.slstm_scan(gx, r, st), ref.slstm_scan(gx, r, st))
    after = ops.launches_by_route(ops.launch_counts(), "slstm_scan")
    assert {k: after[k] - before[k] for k in after} == {
        "cluster": 1, "per_row": 0}
    cs, bt = SL.card_cluster_plan(b, heads, p_dim, 0)
    assert heads * -(-b // bt) > SL.max_clusters(0, p_dim, cs, bt)


def test_xlstm_layers_reach_the_scan_kernels(card):
    """The card path of the model: a reduced xLSTM prefill launches the
    chunked scan once per mLSTM layer and the sLSTM kernel once per sLSTM
    layer; a decode step only the sLSTM kernel."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    cfg = configs.get_config("xlstm-125m", reduced=True)
    params = T.init_params(cfg, seed=0)
    toks = torch.zeros((2, 16), dtype=torch.int32, device="cuda")
    ops.reset_launch_counts()
    logits, cache, idx = T.prefill(params, cfg, {"tokens": toks}, 20)
    logits, cache = T.decode_step(params, cfg, cache,
                                  {"tokens": toks[:, :1]}, idx)
    counts = ops.launch_counts()
    assert counts["ssm_scan"] == 4 and counts["slstm_scan"] == 2 * 2
    assert bool(logits.isfinite().all())


def test_scan_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = _randn(card, 1, 2, 100, 8)
    st = torch.zeros((1, 2, 8, 8), device="cuda")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm_scan_cuda(x, x, x, x[..., 0], st, chunk=64)
    with pytest.raises(ValueError, match="chunk"):
        y = _randn(card, 1, 2, 128, 8)
        ssm_scan_cuda(y, y, y, y[..., 0], st, chunk=128)
    with pytest.raises(TypeError, match="float32"):
        slstm_scan_cuda(_randn(card, 1, 3, 32, dtype=torch.bfloat16),
                        _randn(card, 2, 4, 16, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="4P"):
        slstm_scan_cuda(_randn(card, 1, 3, 4 * 257),
                        _randn(card, 1, 257, 4 * 257))
    from repro_torch.kernels import slstm_scan as SL
    for launch in (SL.launch_cluster, SL.launch_per_row):
        with pytest.raises(TypeError, match="float32"):
            launch(_randn(card, 1, 3, 32, dtype=torch.bfloat16),
                   _randn(card, 2, 4, 16, dtype=torch.bfloat16))
        with pytest.raises(ValueError, match="4P"):
            launch(_randn(card, 1, 3, 4 * 257), _randn(card, 1, 257, 4 * 257))
        with pytest.raises(ValueError, match="S 0"):
            launch(_randn(card, 1, 0, 32), _randn(card, 2, 4, 16))
    gx, r = _randn(card, 2, 3, 4 * 64), _randn(card, 1, 64, 4 * 64)
    for plan in [(17, 1), (0, 1), (2, 0), (9, 1)]:    # (9, 1): a block of
        with pytest.raises(ValueError, match="does not take"):  # no unit
            SL.launch_cluster(gx, r, plan=plan)


def _ssm_model_inputs(card, b, s, h, dk, dv, carried=False):
    """The xLSTM scan's operands: q·dk^-0.5, k·sigmoid(i-gate), v with its
    column of ones, log_f = log_sigmoid(3 + noise), bf16."""
    q = (_randn(card, b, s, h, dk) * dk ** -0.5).bfloat16()
    k = (_randn(card, b, s, h, dk)
         * torch.sigmoid(_randn(card, b, s, h))[..., None]).bfloat16()
    v = _randn(card, b, s, h, dv).bfloat16()
    v[..., -1] = 1.0
    g = ref.log_sigmoid(3.0 + _randn(card, b, s, h))
    st = _randn(card, b, h, dk, dv) if carried else None
    return q, k, v, g, st


def _ssm_close(got, want):
    _close(got[0], want[0], TOL_SCAN[torch.bfloat16])
    _close(got[1], want[1], TOL_SCAN[torch.float32])
    assert bool(got[0].isfinite().all()) and bool(got[1].isfinite().all())


@pytest.mark.parametrize("b,s", [(4, 512), (128, 512)])
def test_ssm_mma_route_at_the_path_shapes(card, b, s):
    """(f)'s shape cut to S 512 (B 4, H 4, dk 384, dv 385) and phase 9
    (ii)'s B 128 x 512, through ``ops``: one launch, on the tensor-core
    route, within the scan tolerances."""
    q, k, v, g, _ = _ssm_model_inputs(card, b, s, 4, 384, 385)
    before = ops.launches_by_route(ops.launch_counts(), "ssm_scan")
    got = ops.ssm_scan(q, k, v, g)
    after = ops.launches_by_route(ops.launch_counts(), "ssm_scan")
    assert {r: after[r] - before[r] for r in after} == {"mma": 1,
                                                        "cuda_cores": 0}
    _ssm_close(got, ref.ssm_scan(q, k, v, g))


@pytest.mark.parametrize("dk,dv", [(16, 9), (32, 24), (384, 385), (48, 100)])
@pytest.mark.parametrize("s,chunk", [(1, 64), (37, 64), (256, 16),
                                     (256, 64)])
@pytest.mark.parametrize("carried", [False, True])
def test_ssm_mma_route_sweep(card, dk, dv, s, chunk, carried):
    """The tensor-core route over chunks 16 and 64, S 1, 37 (chunk = S)
    and 256, dv 9, 24, 100 and 385 (ragged last m-tiles), zero and carried
    states, against the plain version."""
    from repro_torch.kernels import ssm_scan as SS
    b, h = 2, 2
    q = (_randn(card, b, s, h, dk) * dk ** -0.5).bfloat16()
    k = _randn(card, b, s, h, dk, dtype=torch.bfloat16)
    v = _randn(card, b, s, h, dv, dtype=torch.bfloat16)
    g = -torch.nn.functional.softplus(_randn(card, b, s, h))
    st = (_randn(card, b, h, dk, dv) if carried
          else torch.zeros((b, h, dk, dv), device="cuda"))
    o, sf = SS.launch_mma(*(x.transpose(1, 2) for x in (q, k, v, g)), st,
                          chunk=chunk)
    _ssm_close((o.transpose(1, 2), sf),
               ref.ssm_scan(q, k, v, g, st, chunk=chunk))


@pytest.mark.parametrize("cs", [5, 6, 7, 9, 16])
def test_ssm_mma_cluster_sizes_match_plain(card, cs):
    """Every cluster size the kernel takes at dv 385 (5 to 16 blocks, 1 to 5
    m-tiles each), the state carried across chunks of 16."""
    from repro_torch.kernels import ssm_scan as SS
    q, k, v, g, st = _ssm_model_inputs(card, 1, 128, 2, 384, 385, True)
    o, sf = SS.launch_mma(*(x.transpose(1, 2) for x in (q, k, v, g)), st,
                          chunk=16, cs=cs)
    _ssm_close((o.transpose(1, 2), sf),
               ref.ssm_scan(q, k, v, g, st, chunk=16))


@pytest.mark.parametrize("cs", [5, 6, 7])
def test_ssm_mma_clusters_stay_in_step_over_long_sequences(card, cs):
    """B 4 x H 4 over 16384 tokens (256 chunks) at the cluster sizes the
    plan takes at the xLSTM widths: the blocks of a cluster exchange each
    chunk's scores through two buffers, so none may run two chunks ahead
    of another (at clusters of 6 one block has five m-tiles and is the
    slowest)."""
    from repro_torch.kernels import ssm_scan as SS
    q, k, v, g, _ = _ssm_model_inputs(card, 4, 16384, 4, 384, 385)
    st = torch.zeros((4, 4, 384, 385), device="cuda")
    o, sf = SS.launch_mma(*(x.transpose(1, 2) for x in (q, k, v, g)), st,
                          cs=cs)
    _ssm_close((o.transpose(1, 2), sf), ref.ssm_scan(q, k, v, g))


def test_ssm_mma_route_runs_past_one_wave(card):
    """B 4 x H 8 at the xLSTM widths: more clusters than the card holds at
    once under the plan, so a second wave, one launch through ``ops``."""
    from repro_torch.kernels import ssm_scan as SS
    b, h = 4, 8
    q, k, v, g, st = _ssm_model_inputs(card, b, 128, h, 384, 385, True)
    cs = SS.card_cluster_plan(b * h, 384, 385, 0)
    assert b * h > SS.max_clusters(0, 384, 385, cs)
    before = ops.launches_by_route(ops.launch_counts(), "ssm_scan")
    got = ops.ssm_scan(q, k, v, g, st)
    after = ops.launches_by_route(ops.launch_counts(), "ssm_scan")
    assert after["mma"] - before["mma"] == 1
    _ssm_close(got, ref.ssm_scan(q, k, v, g, st))


def test_ssm_scan_launches_by_route(card):
    """Through ``ops``: bf16 at dk 16 and 384 on the tensor cores, f32 (at
    any dk) and bf16 at dk 8 on the CUDA cores."""
    cases = [(torch.bfloat16, 16, "mma"), (torch.bfloat16, 384, "mma"),
             (torch.float32, 384, "cuda_cores"), (torch.float32, 16,
                                                  "cuda_cores"),
             (torch.bfloat16, 8, "cuda_cores")]
    for dtype, dk, route in cases:
        q = _randn(card, 2, 64, 2, dk, dtype=dtype)
        v = _randn(card, 2, 64, 2, dk + 1, dtype=dtype)
        g = -torch.nn.functional.softplus(_randn(card, 2, 64, 2))
        before = ops.launches_by_route(ops.launch_counts(), "ssm_scan")
        ops.ssm_scan(q, q, v, g)
        after = ops.launches_by_route(ops.launch_counts(), "ssm_scan")
        assert {r: after[r] - before[r] for r in after} == {
            r: int(r == route) for r in after}, (dtype, dk)


def test_ssm_mma_launcher_refuses_what_it_does_not_take(card):
    """f32 operands, dk the kernel does not take, q or k not 16-byte
    aligned (base or row stride) and cluster sizes outside 1..5 m-tiles a
    block raise; nothing falls back to the CUDA cores."""
    from repro_torch.kernels import ssm_scan as SS
    b, h, s, dk, dv = 1, 2, 64, 32, 33
    st = torch.zeros((b, h, dk, dv), device="cuda")
    g = torch.zeros((b, h, s), device="cuda")
    q = _randn(card, b, h, s, dk, dtype=torch.bfloat16)
    v = _randn(card, b, h, s, dv, dtype=torch.bfloat16)
    before = ops.launch_counts()
    with pytest.raises(TypeError, match="bfloat16"):
        SS.launch_mma(q.float(), q.float(), v.float(), g, st)
    with pytest.raises(ValueError, match="dk 24"):
        SS.launch_mma(q[..., :24], q[..., :24], v, g, st[:, :, :24])
    wide = _randn(card, b, h, s, dk + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned base"):
        SS.launch_mma(wide[..., 1:], q, v, g, st)
    rows = _randn(card, b, h, s, dk + 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned strides"):
        SS.launch_mma(q, rows[..., :dk], v, g, st)
    for cs in (0, 17, 4):   # dv 33: 3 m-tiles, clusters of 1..3
        with pytest.raises(ValueError, match="clusters of"):
            SS.launch_mma(q, q, v, g, st, cs=cs or -1)
    assert ops.launch_counts() == before



def _chip_smoke():
    """``chip_smoke.py`` as a module: its overload scenario
    (``overload_saturation``, which ``tests/test_torch_overload.py`` holds
    against the JAX package) is the one run here."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kw", [{}, {"prefill_chunk": 8}],
                         ids=["paged", "chunked"])
def test_overload_engines_match_the_cpu(card, kw):
    """Overload control's saturation scenario on the card (f32 small
    proxies, the paged kernels on their CUDA-core routes): the same
    outcomes, rejections, finished order and tokens, overload counts,
    counters and pages as on the CPU."""
    from repro_torch.configs.spaceverse_pair import proxy_pair
    from repro_torch.core import eo_adapter as EO
    from repro_torch.core.cascade import TierModel
    from repro_torch.data import synthetic
    from repro_torch.tree import tree_map
    smoke = _chip_smoke()
    sat_cfg, gs_cfg = proxy_pair("small")
    ac = EO.EOAdapterConfig()
    cpu = (TierModel(EO.init_adapter(gs_cfg, ac, 1, device="cpu"), gs_cfg),
           TierModel(EO.init_adapter(sat_cfg, ac, 0, device="cpu"), sat_cfg))
    on_card = tuple(TierModel(tree_map(lambda t: t.to("cuda"), t.params),
                              t.cfg) for t in cpu)
    images = synthetic.make_dataset(
        "cls", 5, seed=90, cfg=synthetic.EOTaskConfig(
            image_size=ac.image_size, grid=ac.grid))["images"]
    want = smoke.overload_saturation(smoke.port_serving(*cpu, ac), images, kw)
    got = smoke.overload_saturation(smoke.port_serving(*on_card, ac), images,
                                    kw)
    assert got == want
    ol = got["state"]["overload"]
    assert ol["preemptions"] >= 1 and ol["rejections"]["expired"] == 1
    assert got["drained"]


def _small_tier(device):
    """The small proxy tier (f32, hd 12, KH 2) from seed 0, made on the CPU
    and copied to ``device``."""
    from repro_torch.configs.spaceverse_pair import proxy_pair
    from repro_torch.core import eo_adapter as EO
    from repro_torch.core.cascade import TierModel
    from repro_torch.tree import tree_map
    cfg, _ = proxy_pair("small")
    ac = EO.EOAdapterConfig()
    params = EO.init_adapter(cfg, ac, 0, device="cpu")
    return TierModel(tree_map(lambda t: t.to(device), params), cfg), ac


def _sharded_stream(ac):
    from repro_torch.data import synthetic
    from repro_torch.serving import Request
    data = synthetic.make_dataset("cls", 8, seed=0, cfg=synthetic.EOTaskConfig(
        image_size=ac.image_size, grid=ac.grid, num_classes=ac.num_classes))
    return [Request(task="det" if i % 4 == 0 else "vqa",
                    image=data["images"][i % 3], prompt=i % 2)
            for i in range(8)]


def _sharded_tokens(device, mesh, kw, cuda_graphs=True):
    """The stream's tokens through ``make_engine_core`` on ``mesh`` (None:
    one device), 4 slots, and the engine's pools' KV-head counts."""
    from repro_torch.serving import EngineCoreConfig, make_engine_core
    tier, ac = _small_tier(device)
    core = make_engine_core(tier, ac, EngineCoreConfig(
        slots=4, answer_vocab=9, mesh=mesh, cuda_graphs=cuda_graphs, **kw))
    core.warmup()
    reqs, out = _sharded_stream(ac), {}
    queue = list(reqs)
    while queue or core.active_count():
        n = min(len(queue), len(core.free_slots()))
        if n:
            core.admit_many(queue[:n])
            del queue[:n]
        for r, t in core.step():
            out[r.request_id] = t.tolist()
    shards = getattr(core, "shards", [core])
    heads = sorted({layer["k"].shape[3] for sh in shards
                    for layer in sh._slot_cache})
    return [out[r.request_id] for r in reqs], heads


SHARDED_FLAVOURS = {"plain": {}, "chunked": {"prefill_chunk": 4}}


def _cuda_tp_rank(rank):
    """A rank of the card's tp-2 world: both flavours on a (1, 2) mesh of
    one card, with the kernels' launches by route (eager steps: a gloo
    all-reduce is not captured)."""
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_host_mesh(model=2, data=1, devices=["cuda:0"] * 2)
    out = {}
    for name, kw in SHARDED_FLAVOURS.items():
        ops.reset_launch_counts()
        toks, heads = _sharded_tokens("cuda", mesh, kw, cuda_graphs=False)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        out[name] = (toks, heads, {
            n: ops.launches_by_route(counts, n)
            for n in ("paged_decode_attention", "paged_prefill_attention")})
    return out


@pytest.mark.parametrize("flavour", sorted(SHARDED_FLAVOURS))
def test_sharded_dp2_engine_matches_the_cpu(card, flavour):
    """A (2, 1) mesh on one card: two shard engines with private pools on
    cuda:0, the same tokens as one engine on the CPU."""
    from repro_torch.launch.mesh import make_host_mesh
    kw = SHARDED_FLAVOURS[flavour]
    want, _ = _sharded_tokens("cpu", None, kw)
    got, heads = _sharded_tokens(
        "cuda", make_host_mesh(model=1, data=2, devices=["cuda:0"] * 2), kw)
    assert got == want
    assert heads == [2]


def test_sharded_tp2_ranks_on_gloo_match_the_cpu(card):
    """A (1, 2) mesh on one card: two rank processes over ``gloo``, their
    all-reduces on CUDA tensors; both ranks give the CPU engine's tokens,
    their pools hold KH 1, the paged kernels run on the CUDA-core route."""
    from repro_torch.launch.mesh import spawn_tp
    ranks = spawn_tp(_cuda_tp_rank, 2, backend="gloo", timeout_s=180)
    for name, kw in SHARDED_FLAVOURS.items():
        want, _ = _sharded_tokens("cpu", None, kw)
        (t0, h0, r0), (t1, h1, _) = ranks[0][name], ranks[1][name]
        assert t0 == t1 == want, name
        assert h0 == h1 == [1]
        kernel = ("paged_prefill_attention" if kw
                  else "paged_decode_attention")
        assert r0[kernel]["cuda_cores"] > 0 and r0[kernel]["mma"] == 0


# ---------------------------------------------------------------------------
# the slot path's captured steps (CUDA graphs) against its eager steps
# ---------------------------------------------------------------------------

GRAPH_FLAVOURS = {"paged": {}, "dense": {"cache_impl": "dense"},
                  "vmap": {"step_impl": "vmap"},
                  "chunked": {"prefill_chunk": 8},
                  "spec_gamma_3": {"spec_gamma": 3},
                  "chunked_spec": {"prefill_chunk": 8, "spec_gamma": 3},
                  "int8": {"kv_dtype": "int8"}, "fp8": {"kv_dtype": "fp8"}}


#: the reduced vision xlstm-125m and the mixed stack (attention, mLSTM,
#: sLSTM): ``chip_smoke.SMALL_RECURRENT``, which phase 3 serves and
#: tests/test_torch_recurrent_serving.py holds against JAX
RECURRENT_TIERS = sorted(_chip_smoke().SMALL_RECURRENT)


def _graph_run(kw, cuda_graphs, dtype="float32", overload=False,
               recurrent=None):
    """The small proxy tier (and its satellite as the drafter), or the
    ``recurrent`` tier of ``RECURRENT_TIERS`` alone, on the card, warmed
    up, serving a stream of det/vqa/cls requests over three scenes on 3
    slots: (tokens by stream position, launch counts of the run, scheduler
    stats, graph stats)."""
    import dataclasses
    from repro_torch.configs.spaceverse_pair import proxy_pair
    from repro_torch.core import eo_adapter as EO
    from repro_torch.core.cascade import TierModel
    from repro_torch.data import synthetic
    from repro_torch.serving import (EngineCore, EngineCoreConfig,
                                     OverloadConfig, Request)
    from repro_torch.serving.request import PRIORITY_URGENT
    sat_cfg, gs_cfg = (dataclasses.replace(c, dtype=dtype)
                       for c in proxy_pair("small"))
    if recurrent is not None:
        gs_cfg = _chip_smoke().recurrent_cfg(recurrent, dtype=dtype)
    ac = EO.EOAdapterConfig()
    gs = TierModel(EO.init_adapter(gs_cfg, ac, 1, device="cuda"), gs_cfg)
    sat = TierModel(EO.init_adapter(sat_cfg, ac, 0, device="cuda"), sat_cfg)
    core = EngineCore(gs, ac, EngineCoreConfig(
        slots=3, answer_vocab=9, cuda_graphs=cuda_graphs,
        overload=OverloadConfig(queue_cap=16) if overload else None, **kw),
        draft=sat if kw.get("spec_gamma") else None)
    core.warmup()
    cfg = synthetic.EOTaskConfig(image_size=ac.image_size, grid=ac.grid)
    reqs = []
    for i, task in enumerate(["det", "vqa", "cls", "det", "vqa", "vqa",
                              "cls", "det", "vqa"]):
        data = synthetic.make_dataset(task, 1, seed=i % 3, cfg=cfg)
        reqs.append(Request(task=task, image=data["images"][0],
                            prompt=int(data["prompts"][0]), scene_id=i % 3))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out, pos = {}, {r.request_id: i for i, r in enumerate(reqs)}
    if overload:
        # a full table of det answers, then an urgent request preempts one
        core.submit_many([r for r in reqs if r.task == "det"])
        for _ in range(3):
            core.step()
        urgent = Request(task="vqa", image=reqs[1].image, prompt=1,
                         scene_id=7, priority=PRIORITY_URGENT)
        pos[urgent.request_id] = len(reqs)
        core.submit_many([urgent] + [r for r in reqs if r.task != "det"])
        while core.queue_depth() or core.active_count():
            for r, t in core.step():
                out[pos[r.request_id]] = t.tolist()
    else:
        queue = list(reqs)
        while queue or core.active_count():
            n = min(len(queue), len(core.free_slots()))
            if n:
                core.admit_many(queue[:n])
                del queue[:n]
            for r, t in core.step():
                out[pos[r.request_id]] = t.tolist()
    torch.cuda.synchronize()
    return (out, ops.launch_counts(), core.scheduler_stats(),
            core.graph_stats())


@pytest.mark.parametrize("flavour", sorted(GRAPH_FLAVOURS))
def test_captured_engine_equals_eager(card, flavour):
    """Every slot-path flavour on the f32 proxies: the captured engine
    gives the eager engine's tokens and launch counts (a replay counts the
    launches its capture recorded), replays graphs, and captures nothing
    after warmup."""
    kw = GRAPH_FLAVOURS[flavour]
    toks, counts, sched, gst = _graph_run(kw, True)
    etoks, ecounts, esched, egst = _graph_run(kw, False)
    assert toks == etoks
    assert counts == ecounts
    assert sched["steps"] == esched["steps"]
    assert gst["captured"] and gst["graphs"] > 0 and gst["replays"] > 0
    assert sched["steady_recompiles"] == 0
    assert not egst["captured"] and egst["graphs"] == 0


@pytest.mark.parametrize("flavour", ["paged", "spec_gamma_3", "chunked"])
def test_captured_engine_equals_eager_in_bf16(card, flavour):
    kw = GRAPH_FLAVOURS[flavour]
    toks, counts, _, _ = _graph_run(kw, True, dtype="bfloat16")
    etoks, ecounts, _, _ = _graph_run(kw, False, dtype="bfloat16")
    assert toks == etoks
    assert counts == ecounts


@pytest.mark.parametrize("flavour", ["paged", "chunked", "spec_gamma_3"])
def test_no_capture_after_warmup_with_preemption(card, flavour):
    """Admissions, releases and a preemption under overload control: every
    step replays a graph captured in warmup (the guard raises under pytest
    otherwise), and the tokens are the eager engine's."""
    kw = GRAPH_FLAVOURS[flavour]
    toks, counts, sched, gst = _graph_run(kw, True, overload=True)
    etoks, ecounts, _, _ = _graph_run(kw, False, overload=True)
    assert sched["overload"]["preemptions"] >= 1
    assert sched["steady_recompiles"] == 0 and gst["replays"] > 0
    assert toks == etoks and counts == ecounts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flavour", ["paged", "dense", "vmap", "int8",
                                     "overload"])
@pytest.mark.parametrize("tier", RECURRENT_TIERS)
def test_captured_recurrent_engine_equals_eager(card, tier, flavour, dtype):
    """A recurrent tier's captured engine (the prefix prefill with its
    state snapshots, the paged admission from the staged snapshots, the
    slot step over every row's state) against its eager engine: the same
    tokens and launch counts, graphs replayed, nothing captured after
    warmup; under overload control, with a preemption re-admitted from its
    scene's snapshot.  In bf16 the mLSTM scan takes its tensor-core route
    (dk 32)."""
    overload = flavour == "overload"
    kw = {} if overload else GRAPH_FLAVOURS[flavour]
    toks, counts, sched, gst = _graph_run(kw, True, dtype, overload, tier)
    etoks, ecounts, esched, _ = _graph_run(kw, False, dtype, overload, tier)
    assert toks == etoks and len(toks) == (10 if overload else 9)
    assert counts == ecounts and sched["steps"] == esched["steps"]
    assert counts["slstm_scan"] > 0
    assert counts["ssm_scan_mma"] == (counts["ssm_scan"] if dtype == "bfloat16"
                                      else 0) and counts["ssm_scan"] > 0
    assert gst["captured"] and gst["graphs"] > 0 and gst["replays"] > 0
    assert sched["steady_recompiles"] == 0
    if overload:
        assert sched["overload"]["preemptions"] >= 1


def test_capture_survives_a_collected_graph(card):
    """A captured graph that a dropped object holds in a reference cycle
    is destroyed when the collector runs, and destroying a graph inside a
    capture invalidates that capture: ``StepGraphs`` runs no collection
    while it captures (here the body asks for one on every allocation
    while it is captured)."""
    import gc
    from repro_torch.serving.graphs import StepGraphs

    class Holder:
        pass

    def drop_a_captured_graph():
        h = Holder()
        h.me = h
        h.graphs = StepGraphs(torch.device("cuda"), True, ("f",))
        y = torch.zeros(4, device="cuda")
        h.graphs.run("f", 0, lambda: y.add_(1))      # eager, then captured
        assert h.graphs.families["f"].captures() == 1

    graphs = StepGraphs(torch.device("cuda"), True, ("f",))
    x = torch.zeros(4, device="cuda")

    def body():
        if torch.cuda.is_current_stream_capturing():
            gc.set_threshold(1, 1, 1)
            assert len([[i] for i in range(256)]) == 256
        x.add_(1)

    threshold = gc.get_threshold()
    gc.collect()
    gc.set_threshold(1 << 20)          # no collection before the capture
    try:
        drop_a_captured_graph()
        graphs.run("f", 0, body)       # eager, then captured
        gc.set_threshold(*threshold)
        graphs.run("f", 0, body)       # replayed
    finally:
        gc.set_threshold(*threshold)
    torch.cuda.synchronize()
    assert x.tolist() == [2.0] * 4
    gc.collect()


def _graphs_on_gloo_rank(rank):
    """A rank of a tp-2 gloo world on the card asking for captured steps:
    the engine must refuse; returns the message."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import EngineCore, EngineCoreConfig
    tier, ac = _small_tier("cuda")
    mesh = make_host_mesh(model=2, data=1, devices=["cuda:0"] * 2)
    try:
        EngineCore(tier, ac, EngineCoreConfig(slots=2, answer_vocab=9,
                                              mesh=mesh))
    except ValueError as e:
        return str(e)
    return None


def test_graphs_on_a_gloo_tp_group_raise(card):
    from repro_torch.launch.mesh import spawn_tp
    for msg in spawn_tp(_graphs_on_gloo_rank, 2, backend="gloo",
                        timeout_s=120):
        assert msg is not None and "gloo" in msg and "cuda_graphs" in msg



# ---------------------------------------------------------------------------
# training: the flash backward kernel and a train step
# ---------------------------------------------------------------------------

def _grads_close(got, want, dtype):
    """The backward's tolerance (``chip_smoke.check_grads``): f32 sums in
    another order, 1e-4·G per element, G the largest |want| over dq, dk
    and dv (no absolute floor, so it scales with the gradients); in bf16
    also 2^-6·|want| (two bf16 ulps)."""
    rtol = 2.0 ** -6 if dtype == torch.bfloat16 else 0.0
    want = [w.float() for w in want]
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        diff = (g.float() - w).abs()
        bound = 1e-4 * scale + rtol * w.abs()
        assert not bool((diff > bound).any()), float(diff.max())


@pytest.mark.parametrize("hd,group,kh,sq,skv,window,softcap,dtype", [
    (12, 1, 2, 1, 1, 0, None, torch.float32),
    (16, 7, 1, 65, 65, 100, 30.0, torch.float32),
    (16, 4, 2, 129, 129, 0, None, torch.float32),         # the ground proxy
    (64, 6, 1, 129, 129, 0, 30.0, torch.float32),
    (128, 6, 2, 64, 64, 100, None, torch.float32),
    (256, 7, 1, 63, 63, 0, None, torch.float32),
    (256, 1, 1, 1025, 1025, 100, 30.0, torch.float32),
    (16, 6, 1, 65, 300, 0, None, torch.float32),          # Sq < Skv
    (128, 6, 2, 1025, 1025, 0, None, torch.bfloat16),     # the 2B's shape
])
def test_flash_bwd_kernel_matches_plain(card, hd, group, kh, sq, skv, window,
                                        softcap, dtype):
    """The backward through autograd (``ops.flash_attention`` on inputs
    that require grad) against the plain backward at the f32 sweep's
    corners (CUDA cores) and the 2B's bf16 shape (the tensor-core route
    since it took bf16 at hd 128, held to its bound); K/V are views of
    buffers NaN past Skv."""
    kw = {"window": window, "softcap": softcap}
    h = kh * group
    q = _randn(card, 2, sq, h, hd, dtype=dtype)
    do = _randn(card, 2, sq, h, hd, dtype=dtype)
    kb, vb = (_randn(card, 2, skv + 16, kh, hd, dtype=dtype)
              for _ in range(2))
    kb[:, skv:], vb[:, skv:] = float("nan"), float("nan")
    k, v = kb[:, :skv], vb[:, :skv]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = ops.launch_counts()["flash_attention_bwd"]
    with torch.enable_grad():
        o = ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(o, leaves, do)
    assert ops.launch_counts()["flash_attention_bwd"] == before + 1
    if bwd_route(dtype, hd) == "wgmma":
        _within_bwd_wgmma_bound(got, q, k, v, o.detach(), do, **kw)
        return
    want = ref.flash_attention_bwd(q, k, v, o.detach(), do, **kw)
    _grads_close(got, want, dtype)


def _within_bwd_wgmma_bound(got, q, k, v, o, do, **kw):
    """The tensor-core backward (``chip_smoke.check_bwd_wgmma``): each
    element within 1e-4·G + 2^-6·|want| + 2^-8·A, want the f32 plain
    version, G the largest |want| over dq, dk and dv, A the same products
    over absolute values (P and dS are rounded to bf16 before them)."""
    f32 = [t.float() for t in (q, k, v, o, do)]
    want = ref.flash_attention_bwd(*f32, **kw)
    a = ref.flash_attention_bwd_abs(*f32, **kw)
    big = max(float(w.abs().max()) for w in want)
    for g, w, x in zip(got, want, a):
        diff = (g.float() - w).abs()
        bound = 1e-4 * big + 2.0 ** -6 * w.abs() + 2.0 ** -8 * x
        assert not bool((diff > bound).any()), float(diff.max())


def _bwd_case(gen, sq, skv, h, kh, hd):
    """bf16 q, do (B 2, Sq, H, hd) and k, v views of (B, Skv + 16, KH, hd)
    buffers NaN past Skv."""
    bf16 = torch.bfloat16
    q, do = (_randn(gen, 2, sq, h, hd, dtype=bf16) for _ in range(2))
    kb, vb = (_randn(gen, 2, skv + 16, kh, hd, dtype=bf16)
              for _ in range(2))
    kb[:, skv:], vb[:, skv:] = float("nan"), float("nan")
    return q, kb[:, :skv], vb[:, :skv], do


@pytest.mark.parametrize("hd,group,kh", [(64, 1, 2), (128, 6, 2),
                                         (128, 7, 1), (64, 6, 1)])
@pytest.mark.parametrize("sq,skv,window,softcap", [
    (1, 1, 0, None), (63, 63, 100, None), (64, 64, 0, 30.0),
    (65, 65, 100, 30.0), (1025, 1025, 0, None), (65, 300, 0, 30.0),
    (65, 300, 100, None)])
def test_flash_bwd_wgmma_route_matches_plain(card, hd, group, kh, sq, skv,
                                             window, softcap):
    """The tensor-core backward through autograd against the plain
    backward under its bound, one launch counted under
    ``flash_attention_bwd_wgmma`` and none on the CUDA cores; K/V views of
    buffers NaN past Skv."""
    kw = {"window": window, "softcap": softcap}
    q, k, v, do = _bwd_case(card, sq, skv, kh * group, kh, hd)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = ops.launches_by_route(ops.launch_counts(), "flash_attention_bwd")
    with torch.enable_grad():
        o = ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(o, leaves, do)
    after = ops.launches_by_route(ops.launch_counts(), "flash_attention_bwd")
    assert after == {"wgmma": before["wgmma"] + 1,
                     "cuda_cores": before["cuda_cores"]}
    _within_bwd_wgmma_bound(got, q, k, v, o.detach(), do, **kw)


def test_flash_bwd_wgmma_is_deterministic_and_lse_is_the_plain_one(card):
    """Two calls of the tensor-core backward give the same bits; the
    forward's lse equals the plain logsumexp within 1e-5; the forward with
    a null lse writes the same output bits as with one."""
    from repro_torch.kernels import flash_attention as FA
    for sq, skv, window, softcap in ((1025, 1025, 0, None),
                                     (65, 300, 100, 30.0)):
        kw = {"window": window, "softcap": softcap}
        q, k, v, do = _bwd_case(card, sq, skv, 12, 2, 128)
        tr = [t.transpose(1, 2) for t in (q, k, v)]
        o, lse = FA.launch_wgmma(*tr, with_lse=True, **kw)
        assert torch.equal(o, FA.launch_wgmma(*tr, **kw))
        want = ref.flash_attention_lse(q.float(), k.float(), **kw)
        assert float((lse - want).abs().max()) <= 1e-5
        runs = [FA.flash_attention_bwd_cuda(*tr, o, do.transpose(1, 2),
                                            lse=lse, **kw)
                for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_flash_bwd_wgmma_refuses_what_it_does_not_take(card):
    """A misaligned view, a missing or malformed lse and an lse on the
    CUDA-core route raise before any launch."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v, do = _bwd_case(card, 70, 70, 2, 1, 128)
    tr = [t.transpose(1, 2) for t in (q, k, v)]
    o, lse = FA.launch_wgmma(*tr, with_lse=True)
    dot = do.transpose(1, 2)
    before = ops.launch_counts()["flash_attention_bwd"]
    buf = _randn(card, 1, 70, 2, 136, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA"):
        FA.flash_attention_bwd_cuda(
            *tr, o, buf[..., 1:129].transpose(1, 2).expand_as(dot), lse=lse)
    with pytest.raises(ValueError, match="lse"):
        FA.flash_attention_bwd_cuda(*tr, o, dot)
    with pytest.raises(ValueError, match="lse"):
        FA.flash_attention_bwd_cuda(*tr, o, dot, lse=lse.contiguous())
    with pytest.raises(ValueError, match="lse"):
        FA.flash_attention_bwd_cuda(*(t.float() for t in (*tr, o, dot)),
                                    lse=lse)
    assert ops.launch_counts()["flash_attention_bwd"] == before


def test_flash_bwd_refuses_what_it_does_not_take(card):
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    q = _randn(card, 1, 2, 8, 12)
    k = _randn(card, 1, 1, 8, 12)
    with pytest.raises(ValueError):
        flash_attention_bwd_cuda(q, k, k, q, q[..., :8])
    with pytest.raises(TypeError):
        flash_attention_bwd_cuda(*(t.half() for t in (q, k, k, q, q)))
    with pytest.raises(ValueError):                   # Sq > Skv
        flash_attention_bwd_cuda(q, k[:, :, :4], k[:, :, :4], q, q)


@pytest.mark.parametrize("tier", ["satellite", "ground"])
def test_train_step_on_the_card_matches_the_cpu(card, tier):
    """One ``make_train_step`` step of a small proxy (the satellite's 4/2
    heads at hd 12; the ground's 8/2 at hd 16, 4 layers; f32, remat
    "nothing", 2 microbatches) on the card against the same step on the
    CPU: loss and metrics within 1e-5 relative; the gradient, as the first
    moment (1 - b1)·g the step leaves, per leaf within 1e-4·max|want| (f32
    sums in another order, scaled to the gradient as the backward's
    tolerance is); the parameters within 1e-5 + 1e-4·|want| of AdamW on
    the CPU applied to the card's own gradient.  Not of the CPU step's
    parameters: Adam's first update lr·g/(|g| + eps) turns a last-bit
    difference in a gradient of ~eps (1e-9 to 1e-8 here) into up to lr,
    which an f32 CPU step already shows against an f64 one."""
    from repro_torch.configs.spaceverse_pair import proxy_pair
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer as TR
    from repro_torch.tree import tree_leaves, tree_map
    sat_cfg, gs_cfg = proxy_pair("small")
    cfg = gs_cfg if tier == "ground" else sat_cfg
    rng = np.random.default_rng(0)
    b, r, s_t = 4, cfg.num_patches, 4
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s_t)),
             "patch_embeds": rng.standard_normal((b, r, cfg.d_model)),
             "targets": rng.integers(0, cfg.vocab_size, (b, r + s_t)),
             "loss_mask": (rng.random((b, r + s_t)) > 0.3)}
    opt = O.OptConfig(lr=1e-3, warmup_steps=1)
    tc = TR.TrainConfig(microbatches=2)
    params0, state0 = TR.init_train_state(cfg, 0, tc, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.clone().to(dev), params0)
        state = tree_map(lambda t: t.clone().to(dev), state0)
        tb = {k: torch.from_numpy(np.asarray(
            v, np.float32 if v.dtype.kind in "fb" else np.int32)).to(dev)
            for k, v in batch.items()}
        ops.reset_launch_counts()
        params, state, m = TR.make_train_step(cfg, opt, tc)(params, state,
                                                           tb)
        counts = ops.launch_counts()
        out[dev] = (params, state, {k: float(v) for k, v in m.items()},
                    counts)
    (_, sc, mc, _), (pg, sg, mg, counts) = out["cpu"], out["cuda"]
    for k in ("loss", "ce", "acc", "grad_norm", "lr"):
        assert abs(mg[k] - mc[k]) <= 1e-5 * max(abs(mc[k]), 1.0), k
    for a, w in zip(tree_leaves(sg["m"]), tree_leaves(sc["m"])):
        diff = (a.cpu() - w).abs()
        assert float(diff.max()) <= 1e-4 * float(w.abs().max()), \
            float(diff.max())
    grads = tree_map(lambda m_: m_.cpu() / (1 - opt.b1), sg["m"])
    want, _, _ = O.apply_updates(tree_map(torch.clone, params0), grads,
                                 tree_map(torch.clone, state0), opt)
    for a, w in zip(tree_leaves(pg), tree_leaves(want)):
        diff = (a.cpu() - w).abs()
        assert not bool((diff > 1e-5 + 1e-4 * w.abs()).any()), \
            float(diff.max())
    # two microbatches, remat "nothing": each block's forward runs twice
    # (the forward and the backward's recompute), its backward once, on
    # the card's kernels
    assert counts["flash_attention_bwd"] == 2 * cfg.num_layers
    assert counts["flash_attention"] == 4 * cfg.num_layers
