"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: every test skips without a CUDA device (it needs the card
and ``nvcc``).  Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances, element by element: attention 1e-4 absolute in float32 (TF32
off) and 1e-5 + 2^-6·|want| in bfloat16 (two bfloat16 ulps: both sides
round an f32 result); region scores, f32 math and output, 1e-5 absolute.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    paged_decode_attention_cuda)
from repro_torch.kernels.paged_prefill_attention import (  # noqa: E402
    paged_prefill_attention_cuda)

pytestmark = pytest.mark.cuda

# (absolute, relative to |want|)
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-5, 2.0 ** -6)}
TOL_REGION = (1e-5, 0.0)


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


@pytest.mark.parametrize("hd,group,sq,skv,window,softcap,dtype", [
    (12, 3, 33, 33, 0, None, torch.float32),
    (16, 2, 70, 70, 16, None, torch.float32),
    (16, 2, 9, 50, 0, 5.0, torch.float32),
    (128, 7, 1025, 1025, 0, None, torch.bfloat16),
    (128, 6, 200, 200, 0, None, torch.float32),
])
def test_flash_attention_kernel_matches_plain(card, hd, group, sq, skv,
                                              window, softcap, dtype):
    kh = 2
    q = _randn(card, 1, sq, kh * group, hd, dtype=dtype)
    k = _randn(card, 1, skv, kh, hd, dtype=dtype)
    v = _randn(card, 1, skv, kh, hd, dtype=dtype)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, window=window, softcap=softcap)
    assert ops.launch_counts()["flash_attention"] == before + 1
    _close(got, ref.flash_attention(q, k, v, window=window, softcap=softcap),
           TOL[dtype])


@pytest.mark.parametrize("hd,group,q_len,window,softcap,dtype", [
    (12, 3, 1, 0, None, torch.float32),
    (16, 2, 3, 0, None, torch.float32),
    (16, 3, 1, 8, 3.0, torch.float32),
    (128, 7, 1, 0, None, torch.bfloat16),
    (128, 6, 3, 5, None, torch.float32),
])
def test_decode_attention_kernel_matches_plain(card, hd, group, q_len,
                                               window, softcap, dtype):
    s, kh = 300, 2
    q = _randn(card, 4, q_len, kh * group, hd, dtype=dtype)
    k = _randn(card, 4, s, kh, hd, dtype=dtype)
    v = _randn(card, 4, s, kh, hd, dtype=dtype)
    lens = torch.tensor([0, 1, 150, s], dtype=torch.int32, device="cuda")
    got = ops.multi_decode_attention(q, k, v, lens, window=window,
                                     softcap=softcap)
    want = ref.multi_decode_attention(q, k, v, lens, window=window,
                                      softcap=softcap)
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
    _close(got, want, TOL[dtype])
    assert float(got[0].abs().max()) == 0.0
    if q_len == 1:
        got1 = ops.paged_decode_attention(q[:, 0], kn, vn, table, lens_t,
                                          window=window, softcap=softcap)
        _close(got1, want[:, 0], TOL[dtype])


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
    longer; NaN trash page; the pools are left as they were."""
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
    _close(got, want, TOL[dtype])
    assert float(got[0].abs().max()) == 0.0
    assert torch.equal(kn.nan_to_num(), kn0.nan_to_num())


@pytest.mark.parametrize("nv,ne,d,dtype", [(1, 1, 1536, torch.bfloat16),
                                           (3, 2, 48, torch.float32)])
def test_region_score_kernel_matches_plain(card, nv, ne, d, dtype):
    v = _randn(card, 2, 100, nv, d, dtype=dtype)
    e = _randn(card, 2, ne, d, dtype=dtype)
    _close(ops.region_score(v, e), ref.region_score(v, e), TOL_REGION)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = _randn(card, 1, 4, 8, 16)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        flash_attention_cuda(q, q[:, :2, :4], q[:, :2, :4])
    with pytest.raises(ValueError, match="head dim"):
        x = _randn(card, 1, 2, 4, 130)
        flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="rows"):
        x = _randn(card, 1, 1, 33, 16)
        decode_attention_cuda(x, x, x, 3)
    with pytest.raises(ValueError, match="share device and dtype"):
        flash_attention_cuda(q, q.bfloat16(), q)
    pool = _randn(card, 6, 2, 8, 16)                 # (n_pages, KH, page, hd)
    table = torch.zeros((1, 3), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="rows"):
        paged_decode_attention_cuda(_randn(card, 1, 2, 65, 16), pool, pool,
                                    table, 3)
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
