"""The port's plain kernel versions against the JAX package's oracles.

Same numpy inputs through ``repro.kernels.ref`` / ``repro.kernels.ops``
(interpret-mode Pallas) and ``repro_torch.kernels.ops`` on the CPU, which
takes the plain PyTorch versions.  float32 throughout; tolerance 5e-5
absolute (float32 sums taken in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest's workers share the cores, and torch's
# default of a thread a core in each worker oversubscribes them
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = 5e-5

torch.backends.cuda.matmul.allow_tf32 = False


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (hd, group, kh, sq, skv, window, softcap)
    (12, 1, 2, 24, 24, 0, None),
    (12, 2, 2, 24, 24, 0, None),
    (12, 3, 1, 24, 24, 0, None),
    (16, 1, 2, 32, 32, 0, None),
    (16, 2, 2, 32, 32, 0, None),
    (16, 3, 2, 32, 32, 0, None),
    (16, 2, 2, 32, 32, 8, None),      # sliding window
    (12, 3, 1, 24, 24, 0, 5.0),       # logit softcap
    (256, 4, 1, 24, 24, 8, None),     # gemma3-1b: hd 256, group 4, window
    (256, 1, 2, 24, 24, 0, 5.0),      # hd 256, group 1, softcap
]


@pytest.mark.parametrize("hd,group,kh,sq,skv,window,softcap", FLASH_CASES)
def test_flash_attention_plain_matches_jax(hd, group, kh, sq, skv, window,
                                           softcap):
    rng = np.random.default_rng(hd * 100 + group * 10 + window)
    q = _rand(rng, 2, sq, kh * group, hd)
    k = _rand(rng, 2, skv, kh, hd)
    v = _rand(rng, 2, skv, kh, hd)
    got = tops.flash_attention(_t(q), _t(k), _t(v), window=window,
                               softcap=softcap)
    want = jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window=window,
                                softcap=softcap)
    _close(got, want)
    if hd == 12 and window == 0 and softcap is None:
        return   # interpret-mode Pallas is slow: hd 16 and the options do
    kernel = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window=window,
                                  softcap=softcap, impl="pallas_interpret")
    _close(got, kernel)


def test_flash_attention_bottom_right_alignment():
    """Sq < Skv: row i sees keys <= i + Skv - Sq, as the JAX oracle."""
    rng = np.random.default_rng(7)
    q = _rand(rng, 1, 5, 4, 16)
    k = _rand(rng, 1, 13, 2, 16)
    v = _rand(rng, 1, 13, 2, 16)
    got = tops.flash_attention(_t(q), _t(k), _t(v))
    want = jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v))
    _close(got, want)


# ---------------------------------------------------------------------------
# the tensor-core flash route: its rounding, its bound, its route rule
# ---------------------------------------------------------------------------

def _emulate_wgmma_flash(q, k, v, *, window=0, softcap=None, tile=64):
    """What the wgmma flash kernel computes, in float32 on the CPU: a tiled
    online softmax over 64-key tiles (base e here, base 2 on the card),
    p rounded to bfloat16 before PV, l summed from the f32 p, the output
    rounded to bfloat16.  Bottom-right causal alignment."""
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    scale = hd ** -0.5
    qf = q.float().reshape(b, sq, kh, h // kh, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]      # (b, kh, 1, skv, hd)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    rows = torch.arange(sq)[:, None] + (skv - sq)
    m = torch.full(qf.shape[:-1] + (1,), -1e30)
    lsum = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, skv, tile):
        cols = torch.arange(k0, min(k0 + tile, skv))[None, :]
        sc = qf @ kf[..., k0:k0 + tile, :].transpose(-1, -2) * scale
        if softcap is not None:
            sc = softcap * torch.tanh(sc / softcap)
        mask = cols <= rows
        if window > 0:
            mask &= cols > rows - window
        sc = torch.where(mask, sc, torch.tensor(float("-inf")))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(sc - m_new)
        lsum = lsum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[..., k0:k0 + tile, :]
        m = m_new
    out = acc / lsum.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).bfloat16()


def wgmma_bound_share(got, q, k, v, **kw):
    """max over elements of |got - want| / (1e-5 + 2^-6·|want| + 2^-8·A),
    want the f32 plain version, A = attention(q, k, |v|): the bound the
    tensor-core route is held to.  bf16's unit roundoff is 2^-8, so rounding
    p moves an output by at most 2^-8·A, the third term exactly; the
    roundings take both signs, which is where the room the tests measure
    comes from."""
    qf, kf, vf = q.float(), k.float(), v.float()
    want = tref.flash_attention(qf, kf, vf, **kw)
    a = tref.flash_attention(qf, kf, vf.abs(), **kw)
    bound = 1e-5 + 2.0 ** -6 * want.abs() + 2.0 ** -8 * a
    return float(((got.float() - want).abs() / bound).max())


@pytest.mark.parametrize("group,kh,hd,sq,skv,window,softcap", [
    (7, 1, 128, 257, 257, 0, None),     # the 7B's group at its head dim
    (6, 2, 64, 65, 200, 0, None),       # ragged Sq < Skv
    (2, 2, 128, 130, 130, 32, None),    # sliding window
    (3, 1, 64, 100, 100, 0, 30.0),      # logit softcap
    (4, 1, 256, 600, 600, 512, None),   # gemma3-1b's local layers
    (4, 1, 256, 300, 600, 0, None),     # its global ones, Sq < Skv
])
def test_wgmma_flash_rounding_stays_within_its_bound(group, kh, hd, sq, skv,
                                                     window, softcap):
    """The tensor-core route rounds p to bf16 before PV, so it cannot meet
    two bf16 ulps of the f32 plain version; an emulation of its arithmetic
    stays within the stated bound with room to spare (at most 0.6 of it),
    and the plain version it is held to equals the JAX oracle."""
    rng = np.random.default_rng(group * 1000 + sq)
    q = _t(_rand(rng, 1, sq, kh * group, hd)).bfloat16()
    k = _t(_rand(rng, 1, skv, kh, hd)).bfloat16()
    v = _t(_rand(rng, 1, skv, kh, hd)).bfloat16()
    kw = dict(window=window, softcap=softcap)
    emulated = _emulate_wgmma_flash(q, k, v, **kw)
    assert wgmma_bound_share(emulated, q, k, v, **kw) <= 0.6
    want = tref.flash_attention(q.float(), k.float(), v.float(), **kw)
    oracle = jref.flash_attention(*(jnp.asarray(t.float().numpy())
                                    for t in (q, k, v)), **kw)
    _close(want, oracle)


def test_flash_route_rule():
    """bf16 at hd 64/128/256 takes the tensor cores; float32 (card-vs-CPU
    decisions in f32 must not flip on TF32 rounding) and other head dims
    take the CUDA cores; any other dtype raises."""
    from repro_torch.kernels.flash_attention import route
    for hd in (64, 128, 256):
        assert route(torch.bfloat16, hd) == "wgmma"
    for dtype, hd in [(torch.float32, 128), (torch.float32, 64),
                      (torch.float32, 256), (torch.bfloat16, 252),
                      (torch.bfloat16, 16), (torch.bfloat16, 12),
                      (torch.bfloat16, 96)]:
        assert route(dtype, hd) == "cuda_cores"
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            route(dtype, 128)


def test_hd256_takes_the_cuda_core_routes_and_260_is_refused():
    """gemma3-1b's head dim 256: bf16 takes the tensor-core route of every
    attention forward (flash on wgmma; dense decode, paged decode and
    prefix-append on mma.sync, whose hd-256 instances stage Q in shared
    memory) and of the flash backward (wgmma, its hd-256 kernels); f32
    takes the CUDA cores everywhere, the backward too; every attention
    wrapper takes it; 260 and dims that are not a multiple of 4 still
    raise, before any launch."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PDA
    from repro_torch.kernels import paged_prefill_attention as PPA
    assert FA.route(torch.bfloat16, 256) == "wgmma"
    assert FA.bwd_route(torch.bfloat16, 256) == "wgmma"
    assert FA.bwd_route(torch.float32, 256) == "cuda_cores"
    assert PDA.route(torch.bfloat16, 256) == "mma"
    assert DA.route(torch.bfloat16, 256) == "mma"
    assert PPA.route(torch.bfloat16, 256) == "mma"
    for m in (FA, DA, PDA, PPA):
        assert m.route(torch.float32, 256) == "cuda_cores"
    assert build.MAX_HEAD_DIM == 256
    for hd in (4, 12, 128, 252, 256):
        build.check_head_dim(hd)
    for hd in (0, 254, 260, 512):
        with pytest.raises(ValueError, match="head dim"):
            build.check_head_dim(hd)


def test_flash_tma_rule_refuses_misaligned_operands():
    """The wgmma route's operands need 16-byte aligned bases and strides;
    a size-1 dimension's stride does not count."""
    from repro_torch.kernels.flash_attention import check_tma
    buf = torch.zeros(2, 4, 33, 136, dtype=torch.bfloat16)
    check_tma(q=buf[..., :128], k=buf[:1, :, :1, 8:72])
    with pytest.raises(ValueError, match="aligned base"):
        check_tma(q=buf[..., 1:129])
    odd = torch.zeros(2, 4, 33, 129, dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="aligned strides"):
        check_tma(k=odd)


# ---------------------------------------------------------------------------
# decode attention (q_len = 1) and the multi-token chunk (q_len = 3)
# ---------------------------------------------------------------------------

DECODE_CASES = [(hd, group, q_len) for hd in (12, 16) for group in (1, 2, 3)
                for q_len in (1, 3)]
DECODE_CASES += [(256, 4, 1), (256, 4, 3), (256, 1, 3)]   # gemma3-1b's hd


def _decode_inputs(hd, group, q_len, s=37, kh=2, b=4, seed=0):
    rng = np.random.default_rng(seed + hd + 10 * group + 100 * q_len)
    q = _rand(rng, b, q_len, kh * group, hd)
    k = _rand(rng, b, s, kh, hd)
    v = _rand(rng, b, s, kh, hd)
    lens = np.array([0, 1, s // 2, s], np.int32)[:b]   # ragged, incl. 0
    return q, k, v, lens


@pytest.mark.parametrize("hd,group,q_len", DECODE_CASES)
def test_decode_attention_plain_matches_jax(hd, group, q_len):
    q, k, v, lens = _decode_inputs(hd, group, q_len)
    kernel = None
    if q_len == 1:
        got = tops.decode_attention(_t(q[:, 0]), _t(k), _t(v), _t(lens))
        want = jref.decode_attention(jnp.asarray(q[:, 0]), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lens))
        if group == 3:   # interpret-mode Pallas is slow: q_len 3 covers it
            kernel = jops.decode_attention(
                jnp.asarray(q[:, 0]), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(lens), impl="pallas_interpret")
    else:
        got = tops.multi_decode_attention(_t(q), _t(k), _t(v), _t(lens))
        want = jref.multi_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(lens))
        kernel = jops.multi_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lens), impl="pallas_interpret")
    _close(got, want)
    if kernel is not None:
        _close(got, kernel)
    # rows with nothing to attend to output zeros
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("window,softcap,q_len",
                         [(8, None, 1), (8, None, 3), (0, 3.0, 1),
                          (5, 2.5, 3)])
def test_decode_attention_window_softcap_match_jax(window, softcap, q_len):
    q, k, v, lens = _decode_inputs(16, 2, q_len, seed=window)
    if q_len == 1:
        got = tops.decode_attention(_t(q[:, 0]), _t(k), _t(v), _t(lens),
                                    window=window, softcap=softcap)
        want = jops.decode_attention(
            jnp.asarray(q[:, 0]), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lens), window=window, softcap=softcap, impl="ref")
        kernel = jops.decode_attention(
            jnp.asarray(q[:, 0]), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lens), window=window, softcap=softcap,
            impl="pallas_interpret")
    else:
        got = tops.multi_decode_attention(_t(q), _t(k), _t(v), _t(lens),
                                          window=window, softcap=softcap)
        want = jref.multi_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lens), window=window, softcap=softcap)
        kernel = jops.multi_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lens), window=window, softcap=softcap,
            impl="pallas_interpret")
    _close(got, want)
    _close(got, kernel)


def test_decode_attention_scalar_length_broadcasts():
    q, k, v, _ = _decode_inputs(12, 3, 1)
    got = tops.decode_attention(_t(q[:, 0]), _t(k), _t(v), 20)
    want = jref.decode_attention(jnp.asarray(q[:, 0]), jnp.asarray(k),
                                 jnp.asarray(v), jnp.int32(20))
    _close(got, want)


# ---------------------------------------------------------------------------
# region score (Eq. 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nv,ne,d", [(1, 1, 48), (3, 2, 16), (2, 5, 128)])
def test_region_score_plain_matches_jax(nv, ne, d):
    rng = np.random.default_rng(nv * 10 + ne)
    v = _rand(rng, 2, 100, nv, d)                      # R = 100 (paper N_r)
    e = _rand(rng, 2, ne, d)
    got = tops.region_score(_t(v), _t(e))
    _close(got, jref.region_score(jnp.asarray(v), jnp.asarray(e)))
    # the Pallas kernel normalises as x·rsqrt(|x|² + 1e-12): ~1e-6 relative
    kernel = jops.region_score(jnp.asarray(v), jnp.asarray(e),
                               impl="pallas_interpret")
    _close(got, kernel, tol=TOL * nv * ne)


def _warp_sum(x):
    """``warp_sum``'s xor butterfly over the last axis (32 lanes)."""
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., lane ^ o]
    return x[..., 0]


def region_score_emulated(v, e, vec, warps=8):
    """``csrc/region_score.cu``'s order of operations in f32: a warp per
    (batch row, region), W regions a block (the last block's spare warps
    padded and dropped); lane l holds units piece·32·UPL + j·32 + l of a
    row (16-byte units of 4 f32 on the vector path, UPL 8; single elements
    on the scalar path, UPL 16) and keeps v·ē and v·v as running sums,
    reduced by the xor butterfly at the row's last piece; ē_d = Σ_j e_jd /
    (‖e_j‖ + 1e-6) summed in j order, ‖e_j‖ from the same lane layout."""
    epu, upl = (4, 8) if vec else (1, 16)
    b, r, nv, d = v.shape
    units = d // epu
    span = 32 * upl
    pieces = -(-units // span)
    r_pad = -(-r // warps) * warps
    v = torch.cat([v, torch.zeros(b, r_pad - r, nv, d)], 1)

    def lane_sums(x, ebar):
        """(..., d) rows -> per-lane (dot, ss), (..., 32) each."""
        dot = torch.zeros(x.shape[:-1] + (32,))
        ss = torch.zeros_like(dot)
        lane = torch.arange(32)
        for p in range(pieces):
            for j in range(upl):
                u = p * span + j * 32 + lane
                live = u < units
                for k in range(epu):
                    idx = torch.where(live, u * epu + k, 0)
                    f = torch.where(live, x[..., idx], 0.0)
                    ss = ss + f * f
                    if ebar is not None:
                        eb = torch.where(live, ebar[..., idx], 0.0)
                        dot = dot + f * eb
        return dot, ss

    _, ess = lane_sums(e, None)
    den = torch.sqrt(_warp_sum(ess)) + 1e-6                  # (B, Ne)
    ebar = torch.zeros(b, d)
    for j in range(e.shape[1]):
        ebar = ebar + e[:, j] / den[:, j, None]
    dot, ss = lane_sums(v, ebar[:, None, None, :])
    score = torch.zeros(b, r_pad)
    for i in range(nv):
        score = score + _warp_sum(dot[:, :, i]) / (
            torch.sqrt(_warp_sum(ss[:, :, i])) + 1e-6)
    return score[:, :r]


@pytest.mark.parametrize("d", [48, 300, 1536])
@pytest.mark.parametrize("ne", [1, 3, 5])
@pytest.mark.parametrize("nv", [1, 3, 5])
def test_region_score_kernel_arithmetic_matches_jax(nv, ne, d):
    """The card kernel's factorised one-pass arithmetic (emulated on the
    CPU, vector and scalar lane layouts) within TOL_REGION (1e-5, the card
    check's tolerance) of the JAX oracle, and within 5e-5·Nv·Ne of the
    interpret-mode Pallas kernel (rsqrt normalisation); R 100, which no
    block of 8 regions divides."""
    rng = np.random.default_rng(1000 + nv * 100 + ne * 10 + d)
    v = _rand(rng, 1, 100, nv, d)
    e = _rand(rng, 1, ne, d)
    want = jref.region_score(jnp.asarray(v), jnp.asarray(e))
    kernel = jops.region_score(jnp.asarray(v), jnp.asarray(e),
                               impl="pallas_interpret")
    for vec in (True, False):
        got = region_score_emulated(_t(v), _t(e), vec)
        _close(got, want, tol=1e-5)
        _close(got, kernel, tol=TOL * nv * ne)


def test_plain_versions_keep_input_dtype():
    rng = np.random.default_rng(3)
    q = _t(_rand(rng, 1, 8, 4, 16)).bfloat16()
    k = _t(_rand(rng, 1, 8, 2, 16)).bfloat16()
    assert tref.flash_attention(q, k, k).dtype == torch.bfloat16
    assert tref.decode_attention(q[:, 0], k, k, 5).dtype == torch.bfloat16
    assert tref.region_score(k, q[:, 0]).dtype == torch.float32


def test_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.region_score import region_score_cuda
    x = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(x, x, x, 3)
    with pytest.raises(ValueError, match="CUDA"):
        region_score_cuda(x, x[0])


@pytest.mark.parametrize("b,kh,s", [(1, 2, 1026), (1, 4, 2049),
                                    (1, 4, 67 * 64), (1, 4, 4288),
                                    (3, 2, 1), (2, 4, 64 * 500 + 5)])
def test_decode_split_plan_covers_the_cache_without_a_cliff(b, kh, s):
    from repro_torch.kernels.decode_attention import KV_TILE, split_plan
    splits, split_len = split_plan(b, kh, s, sm_count=132)
    assert split_len % KV_TILE == 0
    assert (splits - 1) * split_len < s <= splits * split_len   # none empty
    n_tiles = -(-s // KV_TILE)
    want = -(-2 * 132 // (b * kh))
    # as many splits as the card wants, or one per tile: a prime tile count
    # does not collapse the plan to one split
    assert min(want, n_tiles) <= 2 * splits
    assert splits <= min(want, n_tiles)


# ---------------------------------------------------------------------------
# the decode kernels' plans and the tensor-core route's rounding
# ---------------------------------------------------------------------------

def test_decode_route_rule():
    """Each decode-family wrapper has its own rule, by the head dims its
    mode of the tensor-core kernel takes: bf16 at hd 64/128/256 takes the
    tensor cores (mma.sync) for dense decode, paged decode and
    prefix-append; float32 and other head dims take the CUDA cores; any
    other dtype raises."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import paged_decode_attention as PDA
    from repro_torch.kernels import paged_prefill_attention as PPA
    mma_dims = {DA: (64, 128, 256), PDA: (64, 128, 256),
                PPA: (64, 128, 256)}
    for m, dims in mma_dims.items():
        for hd in (12, 16, 64, 96, 128, 256):
            want = "mma" if hd in dims else "cuda_cores"
            assert m.route(torch.bfloat16, hd) == want, (m.__name__, hd)
            assert m.route(torch.float32, hd) == "cuda_cores"
        for dtype in (torch.float16, torch.float64):
            with pytest.raises(TypeError):
                m.route(dtype, 128)
    assert DA.MMA_HEAD_DIMS == {DA.MMA_DENSE: mma_dims[DA],
                                DA.MMA_PAGED: mma_dims[PDA],
                                DA.MMA_PREFILL: mma_dims[PPA]}


def _pieces(rows, group, max_rows):
    """The row tiles as chunk-token ranges (whole tokens each)."""
    from repro_torch.kernels.decode_attention import row_tiles
    tiles = row_tiles(rows, group, max_rows)
    assert tiles[0][0] == 0 and tiles[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
    assert all(0 < r1 - r0 <= max_rows for r0, r1 in tiles)
    assert all(r0 % group == 0 and r1 % group == 0 for r0, r1 in tiles)
    return [(r0 // group, r1 // group) for r0, r1 in tiles]


@pytest.mark.parametrize("paged,q_len,group,max_rows,n_tiles", [
    (True, 10, 7, 64, 2),     # the 7B verifier at γ 9: 70 rows, 63 + 7
    (False, 5, 7, 32, 2),     # dense 35 rows on the CUDA cores: 28 + 7
    (False, 10, 7, 64, 2),    # dense 70 rows on the tensor cores
    (True, 11, 6, 64, 2),     # the 2B verifier at γ 10: 66 rows
])
def test_row_tile_plan_composes_to_the_whole_call(paged, q_len, group,
                                                  max_rows, n_tiles):
    """Each row tile, scored as a sub-chunk of its whole tokens [t0, t1)
    with cache_len less the tokens after it (clamped at 0), equals the
    whole chunk's rows: the kernels' global row index in the mask
    (eff = cache_len - (q_len - 1) + t) gives the same columns.  Lengths
    include 0 and rows shorter than the chunk."""
    pieces = _pieces(q_len * group, group, max_rows)
    assert len(pieces) == n_tiles
    rng = np.random.default_rng(q_len * 100 + group)
    b, kh, hd, page, width = 5, 2, 16, 8, 12
    q = _t(_rand(rng, b, q_len, kh * group, hd))
    lens = _t(np.array([0, 3, q_len, 50, 96], np.int32))
    if paged:
        k_pool = _t(_rand(rng, 1 + b * width, page, kh, hd))
        v_pool = _t(_rand(rng, 1 + b * width, page, kh, hd))
        table = _t(1 + rng.permutation(b * width).reshape(b, width)
                   .astype(np.int32))

        def call(qq, ll):
            return tref.paged_multi_decode_attention(qq, k_pool, v_pool,
                                                     table, ll)
    else:
        k = _t(_rand(rng, b, 96, kh, hd))
        v = _t(_rand(rng, b, 96, kh, hd))

        def call(qq, ll):
            return tref.multi_decode_attention(qq, k, v, ll)
    whole = call(q, lens)
    parts = [call(q[:, t0:t1], torch.clamp(lens - (q_len - t1), min=0))
             for t0, t1 in pieces]
    _close(torch.cat(parts, dim=1), whole)
    assert float(whole[0].abs().max()) == 0.0


#: clusters of n blocks (n = 1..16) of the tensor-core kernel that an
#: NVIDIA H100 80GB HBM3 holds at once at hd 128, for every mode and row
#: tile (``cudaOccupancyMaxActiveClusters``, as chip_smoke.py phase 2
#: prints it): two blocks an SM, fewer for clusters the GPCs split badly
H100_CLUSTERS = {1: 264, 2: 132, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30,
                 9: 23, 10: 21, 11: 16, 12: 16, 13: 14, 14: 14, 15: 14,
                 16: 14}


@pytest.mark.parametrize("clusters,s", [(4, 2049), (2, 1026), (32, 2056),
                                        (16, 2056), (1, 1), (1, 64),
                                        (300, 5000), (8, 65)])
def test_cluster_plan_covers_the_cache_with_no_empty_split(clusters, s):
    """The tensor-core kernel's split plan: whole 64-key tiles per split,
    no split empty of cache slots, the cache covered, at most MAX_CLUSTER
    blocks a cluster, every cluster on the card at once, and as many
    splits as fit where the cache has the tiles for them."""
    from repro_torch.kernels.decode_attention import (KV_TILE, MAX_CLUSTER,
                                                      cluster_plan)
    splits, split_len = cluster_plan(clusters, s, H100_CLUSTERS.get)
    assert split_len % KV_TILE == 0 and 1 <= splits <= MAX_CLUSTER
    assert (splits - 1) * split_len < s <= splits * split_len
    n_tiles = -(-s // KV_TILE)
    fit = max([n for n in H100_CLUSTERS if clusters <= H100_CLUSTERS[n]],
              default=1)
    # the most that fit, the cluster allows and the tiles give, within the
    # rounding to whole tiles per split; none waits for a second wave
    assert min(fit, n_tiles) <= 2 * splits
    assert splits == 1 or clusters <= H100_CLUSTERS[splits]


@pytest.mark.parametrize("clusters,s,plan", [
    (16, 2056, (11, 192)),     # (a) 2B slot step, B 8 x KH 2
    (32, 2056, (7, 320)),      # (b) 7B slot step, B 8 x KH 4
    (16, 2056, (11, 192)),     # (c) 7B verify q_len 5, B 4 x KH 4
    (4, 2049, (11, 192)),      # 7B dense decode, KH 4
    (2, 1026, (9, 128)),       # 2B dense decode, KH 2
    (52, 2056, (4, 576)),      # (e) 2B 256-token chunk: 26 row tiles x 2
    (70, 2056, (3, 704)),      # (d) 2B flat step: 35 plan tiles x 2
])
def test_cluster_plan_at_the_path_shapes(clusters, s, plan):
    """On the H100's occupancy the one planner gives the decode shapes the
    plans of the two-blocks-an-SM rule they had before it (no decode
    launch changed), and prefix-append at (d) / (e) the most splits whose
    clusters all fit at once (5 at (e) would not: 52 > 47)."""
    from repro_torch.kernels.decode_attention import cluster_plan
    assert cluster_plan(clusters, s, H100_CLUSTERS.get) == plan


def _emulate_mma_decode(q, k, v, lens, *, window=0, softcap=None,
                        splits=1, split_len=None, tile=64, start=0):
    """What the tensor-core decode kernel computes, in float32 on the CPU:
    per key split (split ``i`` from key ``start + i·split_len``), an online
    softmax in base 2 over 64-key tiles with p rounded to bf16 before PV
    and l summed from the f32 p; the splits merged in f32; the output
    rounded to bf16.  q (B, T, H, hd), k/v (B, S, KH, hd), cache_len
    INCLUDING the chunk."""
    b, t, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    split_len = split_len or s
    log2e = 1.4426950408889634
    qf = q.float().reshape(b, t, kh, g, hd).permute(0, 2, 1, 3, 4) \
        .reshape(b, kh, t * g, hd)
    kf, vf = k.float().permute(0, 2, 1, 3), v.float().permute(0, 2, 1, 3)
    ln = torch.clamp(lens.long(), max=s)[:, None, None, None]
    eff = ln - (t - 1) + (torch.arange(t * g) // g)[None, None, :, None]
    parts = []
    for sp in range(splits):
        s0 = start + sp * split_len
        s1 = min(s0 + split_len, s)
        m = torch.full(qf.shape[:-1] + (1,), -1e30)
        lsum, acc = torch.zeros_like(m), torch.zeros_like(qf)
        for k0 in range(s0, s1, tile):
            cols = torch.arange(k0, min(k0 + tile, s1))
            x = qf @ kf[:, :, cols].transpose(-1, -2) * hd ** -0.5
            if softcap is not None:
                x = softcap * torch.tanh(x / softcap)
            ok = (cols < ln) & (cols < eff)
            if window > 0:
                ok &= cols >= eff - window
            x = torch.where(ok, x * log2e, torch.tensor(-1e30))
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            p = torch.where(ok, torch.exp2(x - m_new), torch.tensor(0.0))
            alpha = torch.exp2(m - m_new)
            lsum = lsum * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.bfloat16().float() @ vf[:, :, cols]
            m = m_new
        parts.append((m, lsum, acc))
    mm = torch.stack([p_[0] for p_ in parts]).amax(0)
    lsum = sum(p_[1] * torch.exp2(p_[0] - mm) for p_ in parts)
    acc = sum(p_[2] * torch.exp2(p_[0] - mm) for p_ in parts)
    out = acc / lsum.clamp_min(1e-30)
    return out.reshape(b, kh, t, g, hd).permute(0, 2, 1, 3, 4) \
        .reshape(b, t, h, hd).bfloat16()


def mma_decode_bound_share(got, q, k, v, lens, **kw):
    """max over elements of |got - want| / (1e-5 + 2^-6·|want| + 2^-8·A),
    want the f32 plain version, A = attention(q, k, |v|): flash's
    tensor-core bound, which the tensor-core decode route is held to."""
    qf, kf, vf = q.float(), k.float(), v.float()
    want = tref.multi_decode_attention(qf, kf, vf, lens, **kw)
    a = tref.multi_decode_attention(qf, kf, vf.abs(), lens, **kw)
    bound = 1e-5 + 2.0 ** -6 * want.abs() + 2.0 ** -8 * a
    return float(((got.float() - want).abs() / bound).max())


@pytest.mark.parametrize("b,q_len,group,kh,hd,s,window,softcap", [
    (1, 1, 7, 4, 128, 2049, 0, None),     # the 7B decode step
    (1, 1, 6, 2, 128, 1026, 0, None),     # the 2B's
    (4, 5, 7, 1, 128, 600, 0, None),      # the 7B verifier at γ 4
    (3, 10, 7, 1, 64, 300, 37, 30.0),     # 70 rows, window, softcap
])
def test_mma_decode_rounding_stays_within_its_bound(b, q_len, group, kh, hd,
                                                    s, window, softcap):
    """The tensor-core decode route rounds p to bf16 before PV; an
    emulation of its arithmetic over the split plan the card would use
    stays within flash's tensor-core bound with room to spare (at most 0.6
    of it), and the plain version it is held to equals the JAX oracle."""
    from repro_torch.kernels.decode_attention import (MMA_MAX_ROWS,
                                                      cluster_plan, row_tile)
    rng = np.random.default_rng(q_len * 1000 + s)
    q = _t(_rand(rng, b, q_len, kh * group, hd)).bfloat16()
    k = _t(_rand(rng, b, s, kh, hd)).bfloat16()
    v = _t(_rand(rng, b, s, kh, hd)).bfloat16()
    lens = _t(np.linspace(max(s // 3, q_len), s, b).astype(np.int32))
    rows = q_len * group
    tiles = -(-rows // row_tile(rows, group, MMA_MAX_ROWS))
    splits, split_len = cluster_plan(b * kh * tiles, s, H100_CLUSTERS.get)
    assert splits > 1
    kw = dict(window=window, softcap=softcap)
    got = _emulate_mma_decode(q, k, v, lens, splits=splits,
                              split_len=split_len, **kw)
    assert mma_decode_bound_share(got, q, k, v, lens, **kw) <= 0.6
    want = tref.multi_decode_attention(q.float(), k.float(), v.float(), lens,
                                       **kw)
    oracle = jref.multi_decode_attention(
        *(jnp.asarray(t_.float().numpy()) for t_ in (q, k, v)),
        jnp.asarray(lens.numpy()), **kw)
    _close(want, oracle)


#: H100_CLUSTERS at hd 256, where one block an SM fits (the bf16 layout
#: takes 230,400 of 232,448 bytes, the int8 one ~195 KB): the same for
#: dense decode and prefix-append, every row tile and both pools
#: (``cudaOccupancyMaxActiveClusters``, as chip_smoke.py phase 2 prints it)
H100_HD256_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15,
                       8: 15, 9: 9, 10: 7, 11: 7, 12: 7, 13: 7, 14: 7,
                       15: 7, 16: 7}


@pytest.mark.parametrize("clusters,s,plan", [
    (8, 2049, (9, 256)),       # g3 decode: B 8 x KH 1
    (16, 2056, (6, 384)),      # g3 chunk: 16 row tiles of 16 tokens
    (25, 2056, (4, 576)),      # g3 flat: the plan's 25 tiles (group 4)
    (1, 1089, (9, 128)),       # generate's dense decode, B 1
])
def test_cluster_plan_at_gemma3_shapes_on_its_occupancy(clusters, s, plan):
    """At hd 256 the card holds half the clusters it holds at hd 128 (one
    block an SM), so the planner gives gemma3-1b's shapes fewer splits than
    the hd-128 table would, and every cluster still on the card at once."""
    from repro_torch.kernels.decode_attention import cluster_plan
    assert all(2 * H100_HD256_CLUSTERS[n] <= H100_CLUSTERS[n] + 1
               for n in range(1, 9))
    got = cluster_plan(clusters, s, H100_HD256_CLUSTERS.get)
    assert got == plan
    assert clusters <= H100_HD256_CLUSTERS[got[0]]
    assert got[0] <= cluster_plan(clusters, s, H100_CLUSTERS.get)[0]


def _gemma3_case(rng, b, q_len, s, lens):
    """bf16 q (B, q_len, 4, 256), k, v (B, S, 1, 256) and int32 lengths."""
    q = _t(_rand(rng, b, q_len, 4, 256)).bfloat16()
    k = _t(_rand(rng, b, s, 1, 256)).bfloat16()
    v = _t(_rand(rng, b, s, 1, 256)).bfloat16()
    return q, k, v, _t(np.asarray(lens, np.int32))


def _oracle_matches_plain(q, k, v, lens, **kw):
    want = tref.multi_decode_attention(q.float(), k.float(), v.float(), lens,
                                       **kw)
    oracle = jref.multi_decode_attention(
        *(jnp.asarray(t_.float().numpy()) for t_ in (q, k, v)),
        jnp.asarray(lens.numpy()), **kw)
    _close(want, oracle)


@pytest.mark.parametrize("window", [512, 0])
def test_mma_decode_rounding_at_gemma3_decode(window):
    """gemma3-1b's dense decode on the tensor cores (B 8, KH 1, group 4, hd
    256; its local layers' window and its global layers'; a row of length
    0): the emulated arithmetic over the split plan of the hd-256
    occupancy stays within 0.6 of the bound, the empty row is zero, and
    the plain version equals the JAX oracle."""
    from repro_torch.kernels.decode_attention import cluster_plan
    s = 2049
    lens = [0] + [1025 + (1024 * i) // 6 for i in range(7)]
    q, k, v, lens = _gemma3_case(np.random.default_rng(window + 3), 8, 1, s,
                                 lens)
    splits, split_len = cluster_plan(8, s, H100_HD256_CLUSTERS.get)
    got = _emulate_mma_decode(q, k, v, lens, window=window, splits=splits,
                              split_len=split_len)
    assert mma_decode_bound_share(got, q, k, v, lens, window=window) <= 0.6
    assert float(got[0].abs().max()) == 0.0
    _oracle_matches_plain(q, k, v, lens, window=window)


@pytest.mark.parametrize("q_len,window", [(1, 512), (5, 0)])
def test_mma_paged_rounding_at_gemma3_slot_step(q_len, window):
    """gemma3-1b's slot step (q_len 1, its local layers' window) and its
    verifier at γ 4 (q_len 5: 20 rows, two fragments; its global layers)
    on the paged tensor-core route: B 8, KH 1, group 4, hd 256, page 8,
    table width 257, a row of length 0, entries past each row's length on
    the zero trash page.  The emulated arithmetic over the split plan of
    the hd-256 occupancy, on the pages the table names, stays within 0.6
    of the bound, the empty row is zero, and the plain version equals the
    JAX oracle."""
    from repro_torch.kernels.decode_attention import (MMA_MAX_ROWS,
                                                      cluster_plan, row_tile)
    b, kh, group, hd, page, width = 8, 1, 4, 256, 8, 257
    rng = np.random.default_rng(q_len * 100 + window)
    lens = np.array([0] + [1025 + (1024 * i) // 6 for i in range(7)],
                    np.int32)
    need = -(-lens // page)
    table = np.zeros((b, width), np.int32)
    perm = rng.permutation(int(need.sum())) + 1      # page 0: the trash
    for r, n0 in enumerate(np.cumsum(need) - need):
        table[r, :need[r]] = perm[n0:n0 + need[r]]
    pools = [_rand(rng, 1 + len(perm), page, kh, hd) for _ in range(2)]
    for pool in pools:
        pool[0] = 0.0
    q = _t(_rand(rng, b, q_len, kh * group, hd)).bfloat16()
    k_pool, v_pool = (_t(x).bfloat16() for x in pools)
    table_t, lens_t = _t(table), _t(lens)
    k, v = (tref.gather_pages(x, table_t) for x in (k_pool, v_pool))
    rows = q_len * group
    tiles = -(-rows // row_tile(rows, group, MMA_MAX_ROWS))
    splits, split_len = cluster_plan(b * kh * tiles, width * page,
                                     H100_HD256_CLUSTERS.get)
    assert (splits, split_len) == (9, 256)
    kw = dict(window=window)
    got = _emulate_mma_decode(q, k, v, lens_t, splits=splits,
                              split_len=split_len, **kw)
    assert mma_decode_bound_share(got, q, k, v, lens_t, **kw) <= 0.6
    assert float(got[0].abs().max()) == 0.0
    want = tref.paged_multi_decode_attention(q.float(), k_pool.float(),
                                             v_pool.float(), table_t,
                                             lens_t, **kw)
    oracle = jref.paged_multi_decode_attention(
        *(jnp.asarray(t_.float().numpy()) for t_ in (q, k_pool, v_pool)),
        jnp.asarray(table), jnp.asarray(lens), **kw)
    _close(want, oracle)


def test_mma_prefill_rounding_at_a_gemma3_chunk():
    """A 64-token chunk of gemma3-1b (group 4, window 512) over a ~700-key
    prefix, as the prefix-append mode scores it: row tiles of 16 tokens,
    each walking only its keys [lo, hi) (hi its last token's length, lo
    its first token's window floor), shared by the cluster's splits in
    whole tiles.  The emulation stays within 0.6 of the bound of the whole
    chunk's plain version, which equals the JAX oracle."""
    from repro_torch.kernels.decode_attention import KV_TILE, cluster_plan
    q_len, s, window, tokens = 64, 768, 512, 16
    lens = _t(np.array([764, 64 + 300], np.int32))
    q, k, v, lens = _gemma3_case(np.random.default_rng(64), 2, q_len, s,
                                 lens.numpy())
    n_tiles = q_len // tokens
    splits, _ = cluster_plan(2 * n_tiles, s, H100_HD256_CLUSTERS.get)
    rows = []
    for b in range(2):
        parts = []
        for t0 in range(0, q_len, tokens):
            t1 = t0 + tokens
            hi = int(lens[b]) - (q_len - t1)
            lo = max(int(lens[b]) - (q_len - 1) + t0 - window, 0)
            per = -(-(hi - lo) // (splits * KV_TILE)) * KV_TILE
            parts.append(_emulate_mma_decode(
                q[b:b + 1, t0:t1], k[b:b + 1], v[b:b + 1],
                lens[b:b + 1] - (q_len - t1), window=window, splits=splits,
                split_len=per, start=lo))
        rows.append(torch.cat(parts, dim=1))
    got = torch.cat(rows)
    assert mma_decode_bound_share(got, q, k, v, lens, window=window) <= 0.6
    _oracle_matches_plain(q, k, v, lens, window=window)


# ---------------------------------------------------------------------------
# the prefix-append kernel's tile plan at the engine's flat shape
# ---------------------------------------------------------------------------

#: fused steps of a 6-slot engine with a 40-token budget: (slot, first
#: position, tokens) runs in flat order; the rest of the rows are padding
PLAN_STEPS = {
    # three decode rows, a prompt row, then two streaming scenes
    "decode + prompt + two scenes": [(0, 40, 1), (1, 55, 1), (2, 33, 1),
                                     (3, 32, 1), (4, 0, 25), (5, 8, 7)],
    # a decode row, then a scene's chunk cut at the budget
    "chunk cut at the budget": [(0, 40, 1), (1, 12, 39)],
    "one scene's chunk": [(2, 0, 40)],
    "idle step": [],
}


def _flat_step(runs, n_slots, tb):
    srow = np.full((tb,), n_slots, np.int32)
    pos = np.zeros((tb,), np.int32)
    j = 0
    for slot, p0, n in runs:
        srow[j:j + n], pos[j:j + n] = slot, p0 + np.arange(n)
        j += n
    return srow, pos


@pytest.mark.parametrize("group", [1, 6, 7])
@pytest.mark.parametrize("step", list(PLAN_STEPS))
def test_prefill_tile_plan_composes_to_the_whole_call(step, group):
    """The plan of a fused step (built from its flat rows' slots and
    positions): every scheduled row falls in exactly one tile and padding
    rows in none; no tile spans two slots or a gap in positions, or holds
    more than 64 query rows; each run takes the fewest tiles; entries past
    the step's tiles are empty.  Each tile, scored as the tensor-core
    kernel scores it (its rows through its first row's table row, each at
    its own cache_len), equals the whole call's rows, which equal the JAX
    oracle's."""
    from repro_torch.kernels import paged_prefill_attention as PPA
    n_slots, tb, kh, hd, page, width = 6, 40, 2, 16, 8, 10
    runs = PLAN_STEPS[step]
    srow, pos = _flat_step(runs, n_slots, tb)
    n_tiles = PPA.plan_tiles(tb, n_slots, group)
    plan = PPA.tile_plan(srow, pos, n_slots, group, n_tiles)
    assert plan.shape == (2, n_tiles) and plan.dtype == np.int32
    first, count = plan
    tpt = PPA.tokens_per_tile(group)
    n = sum(-(-c // tpt) for _, _, c in runs)
    assert (count[:n] > 0).all() and not count[n:].any()
    assert not first[n:].any()
    assert (count <= tpt).all() and (count * group <= 64).all()
    cover = np.zeros((tb,), int)
    for j0, c in zip(first[:n], count[:n]):
        cover[j0:j0 + c] += 1
        assert (srow[j0:j0 + c] == srow[j0]).all()
        assert (np.diff(pos[j0:j0 + c]) == 1).all()
    np.testing.assert_array_equal(cover, srow < n_slots)

    rng = np.random.default_rng(group * 10 + len(runs))
    q = _t(_rand(rng, tb, 1, kh * group, hd))
    k_pool = _t(_rand(rng, 1 + n_slots * width, page, kh, hd))
    v_pool = _t(_rand(rng, 1 + n_slots * width, page, kh, hd))
    slot_tables = 1 + rng.permutation(n_slots * width).reshape(
        n_slots, width).astype(np.int32)
    table = _t(slot_tables[np.minimum(srow, n_slots - 1)])
    lens = _t(pos + 1)
    whole = tref.paged_prefill_attention(q, k_pool, v_pool, table, lens)
    for j0, c in zip(first[:n], count[:n]):
        part = tref.paged_prefill_attention(
            q[j0:j0 + c], k_pool, v_pool, table[j0].expand(c, -1),
            lens[j0:j0 + c])
        _close(part, whole[j0:j0 + c])
    oracle = jops.paged_prefill_attention(
        *(jnp.asarray(t_.numpy()) for t_ in (q, k_pool, v_pool, table,
                                             lens)), impl="ref")
    _close(whole, oracle)


@pytest.mark.parametrize("group", [1, 6, 7])
def test_prefill_plan_length_holds_every_fused_step(group):
    """``plan_tiles`` holds the tiles of any step the engine can schedule
    (each slot at most one run a step: a decode row, a prompt row or its
    scene's chunk, in any order and lengths, with padding), so the plan's
    fixed length never overflows; a plan made too short raises."""
    from repro_torch.kernels import paged_prefill_attention as PPA
    rng = np.random.default_rng(group)
    for tb, n_slots in ((40, 6), (264, 8), (7, 2), (20, 19)):
        n_tiles = PPA.plan_tiles(tb, n_slots, group)
        assert n_tiles <= tb
        for _ in range(50):
            slots = rng.permutation(n_slots)[:rng.integers(0, n_slots + 1)]
            cuts = np.sort(rng.integers(0, tb + 1, len(slots)))
            lens = np.diff(np.concatenate([[0], cuts]))
            runs = [(int(s), int(rng.integers(0, 500)), int(c))
                    for s, c in zip(slots, lens)]
            srow, pos = _flat_step(runs, n_slots, tb)
            plan = PPA.tile_plan(srow, pos, n_slots, group, n_tiles)
            assert int(plan[1].sum()) == int((srow < n_slots).sum())
    srow, pos = _flat_step([(0, 0, 40)], 6, 40)
    with pytest.raises(ValueError, match="row tiles"):
        PPA.tile_plan(srow, pos, 6, group, -(-40 // PPA.tokens_per_tile(
            group)) - 1)


# ---------------------------------------------------------------------------
# the sLSTM cluster kernel's planner and the route rule
# ---------------------------------------------------------------------------

#: clusters of cs blocks of the sLSTM cluster kernel at P 192 that an NVIDIA
#: H100 80GB HBM3 (132 SMs) holds at once (``cudaOccupancyMaxActiveClusters``
#: as tools/slstm_probe.py prints it for every plan the planner weighs at
#: B 4, 128 and 256): one count a cluster size for every group size, except
#: clusters of 16 over groups of 37 rows or more, whose shared memory leaves
#: one block an SM (7).  Clusters of fewer than 8 do not fit at P 192 (more
#: than 768 threads a block).
H100_SLSTM_CLUSTERS = {8: 15, 9: 9, 10: 7, 11: 7, 12: 7, 13: 7, 14: 7,
                       15: 7, 16: 14}
H100_SMS = 132


def _slstm_fits(cs, bt):
    return 7 if cs == 16 and bt >= 37 else H100_SLSTM_CLUSTERS.get(cs, 0)


def _waves(b, heads, cs, bt):
    n = _slstm_fits(cs, bt)
    return -(-heads * -(-b // bt) // n) if n else None


@pytest.mark.parametrize("b,heads", [(4, 4), (128, 4), (1, 4), (3, 4),
                                     (5, 4), (2, 4), (64, 4), (1, 1),
                                     (7, 2), (128, 1), (256, 4), (4, 16),
                                     (128, 8)])
def test_slstm_cluster_plan_covers_each_row_and_unit_once(b, heads):
    """The planner's (cs, bt) at P 192 on the H100's occupancy: every batch
    row in exactly one group and every unit in exactly one block (none
    empty), at most MAX_CLUSTER blocks a cluster, the block within its
    threads and shared memory, the fewest waves of clusters any plan
    gives (one on the 132 SMs wherever a plan holds every cluster at once;
    B 256 and H 8-16 take two), and no plan with as few waves and a larger
    cluster, or the same cluster and fewer groups."""
    from repro_torch.kernels import slstm_scan as SL
    p = 192
    cs, bt = SL.cluster_plan(b, heads, p, _slstm_fits)
    assert 1 <= cs <= SL.MAX_CLUSTER and SL.plan_fits_block(p, cs, bt)
    groups = -(-b // bt)
    rows = np.zeros(b, int)
    for g in range(groups):
        rows[g * bt:min(b, (g + 1) * bt)] += 1
    assert (rows == 1).all()
    up = SL.units_per_block(p, cs)
    units = np.zeros(p, int)
    for k in range(cs):
        assert k * up < p, "a block owns no unit"
        units[k * up:min(p, (k + 1) * up)] += 1
    assert (units == 1).all()
    assert 32 * up <= SL.block_limit(p)
    assert SL.smem_bytes(p, cs, bt) <= SL.SMEM_LIMIT
    waves = _waves(b, heads, cs, bt)
    assert waves == (2 if (b, heads) in ((256, 4), (4, 16), (128, 8))
                     else 1)
    if waves == 1:
        assert heads * groups * cs <= 2 * H100_SMS
    for cs2 in range(1, SL.MAX_CLUSTER + 1):
        for g2 in range(1, b + 1):
            bt2 = -(-b // g2)
            if not SL.plan_fits_block(p, cs2, bt2) or not _slstm_fits(
                    cs2, bt2):
                continue
            w2 = _waves(b, heads, cs2, bt2)
            assert w2 >= waves
            if w2 == waves and (cs2, bt2) != (cs, bt):
                assert cs2 < cs or (cs2 == cs and bt2 < bt)


@pytest.mark.parametrize("b,heads,plan", [
    (4, 4, (16, 4)), (128, 4, (8, 43)), (256, 4, (8, 52)),
    (4, 16, (16, 4)), (128, 8, (8, 43))])
def test_slstm_cluster_plan_at_the_path_shapes(b, heads, plan):
    """xlstm-125m's sLSTM (H 4, P 192): (g) and the decode launches at B 4
    take one cluster of 16 a head (4 clusters, every row in one group);
    (g') and decode at B 128 take 12 clusters of 8 (groups of 43 rows),
    the largest clusters the card holds all at once.  Past one wave the
    plans ``tools/slstm_probe.py`` timed: B 256 takes 20 clusters of 8
    (groups of 52) in two waves, H 16 at B 4 16 clusters of 16 and H 8
    at B 128 24 clusters of 8, two waves each."""
    from repro_torch.kernels import slstm_scan as SL
    assert SL.cluster_plan(b, heads, 192, _slstm_fits) == plan


def test_slstm_cluster_plan_raises_only_when_no_cluster_fits():
    """Clusters the card cannot hold at once still get a plan (more waves);
    a card that holds no cluster of the kernel at all gets an error."""
    from repro_torch.kernels import slstm_scan as SL
    assert SL.cluster_plan(4, 64, 192, lambda cs, bt: 1) == (16, 4)
    with pytest.raises(ValueError, match="no cluster"):
        SL.cluster_plan(4, 4, 192, lambda cs, bt: 0)


def test_slstm_route_rule():
    """P >= 64 takes the cluster kernel, smaller P the per-row one; ``ops``
    counts both under "slstm_scan" and the cluster route under its key."""
    from repro_torch.kernels import slstm_scan as SL
    assert [SL.route(p) for p in (1, 8, 32, 63, 64, 100, 192, 256)] == [
        "per_row"] * 4 + ["cluster"] * 4
    assert tops.ROUTES["slstm_scan"] == ("slstm_scan_cluster", "cluster",
                                         "per_row")
    counts = {"slstm_scan": 10, "slstm_scan_cluster": 4}
    assert tops.launches_by_route(counts, "slstm_scan") == {
        "cluster": 4, "per_row": 6}


# ---------------------------------------------------------------------------
# ssm_scan: the tensor-core route's rule, plan and chunk arithmetic
# ---------------------------------------------------------------------------

#: chip_smoke.py's scan tolerances (absolute, relative to |want|): the f32
#: state, and a bf16 output (two bf16 ulps of the plain value)
TOL_SCAN = (1e-4, 1e-4)
TOL_SCAN_BF16 = (1e-4, 2.0 ** -6)
#: clusters of cs blocks of the tensor-core scan an H100 (132 SMs) holds at
#: once at dk 384 (cudaOccupancyMaxActiveClusters, one 320-thread block an
#: SM; chip_smoke.py phase 2 prints it, read on an H100 80GB HBM3)
H100_SSM_CLUSTERS = {5: 22, 6: 17, 7: 15, 8: 15, 9: 9,
                     **{cs: 7 for cs in range(10, 17)}}


def test_ssm_scan_route_rule():
    """bf16 with dk % 16 == 0 (up to 384) takes the tensor-core kernel; f32
    and every other dk the CUDA-core one.  ``ops`` counts both under
    "ssm_scan" and the tensor-core route under its key."""
    from repro_torch.kernels import ssm_scan as SS
    bf, f32 = torch.bfloat16, torch.float32
    assert [SS.route(bf, dk) for dk in (16, 32, 48, 384)] == ["mma"] * 4
    assert [SS.route(bf, dk) for dk in (8, 12, 24, 400)] == [
        "cuda_cores"] * 4
    assert [SS.route(f32, dk) for dk in (8, 16, 384)] == ["cuda_cores"] * 3
    assert tops.ROUTES["ssm_scan"] == ("ssm_scan_mma", "mma", "cuda_cores")
    counts = {"ssm_scan": 8, "ssm_scan_mma": 8}
    assert tops.launches_by_route(counts, "ssm_scan") == {"mma": 8,
                                                          "cuda_cores": 0}


@pytest.mark.parametrize("chains,dv,plan,waves", [
    (16, 385, 6, 1),      # (f) and phase 9 (i): B 4 x H 4
    (512, 385, 5, 24),    # (f') and phase 9 (ii): B 128 x H 4
    (4, 385, 16, 1),      # one cluster of 16 a chain fits
    (8, 9, 1, 1),         # one m-tile: a block a chain
    (40, 100, 3, 1)])     # 7 m-tiles: clusters of 3 (44 at once)
def test_ssm_cluster_plan_on_the_h100_table(chains, dv, plan, waves):
    """The tensor-core scan's cluster size on the H100's occupancy: every
    block owns 1..5 16-column m-tiles of dv; the fewest waves (all 16
    chains of the B 4 prefill at once with clusters of 6: 17 fit, against
    15 of 7 or 8), then the largest cluster; more waves where no size
    holds every chain."""
    from repro_torch.kernels import ssm_scan as SS
    n_mt = -(-dv // 16)
    sizes = list(SS.cluster_sizes(dv))
    assert sizes == list(range(-(-n_mt // SS.MMA_MAX_TILES),
                               min(SS.MAX_CLUSTER, n_mt) + 1))

    def fits(cs):
        return H100_SSM_CLUSTERS.get(cs, 132 // cs)

    cs = SS.cluster_plan(chains, dv, fits)
    assert cs == plan and cs in sizes
    assert -(-chains // fits(cs)) == waves
    assert all(-(-chains // fits(c)) >= waves for c in sizes)
    assert SS.cluster_plan(chains, dv, lambda c: 1) == sizes[-1]
    with pytest.raises(ValueError, match="no cluster"):
        SS.cluster_plan(chains, dv, lambda c: 0)


def _split(x):
    """An f32 operand as the tensor-core route feeds it: bf16 hi + bf16 lo
    (lo = bf16(x - hi)), summed in f32."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float()


def mma_scan_emulation(q, k, v, log_g, state, chunk):
    """The tensor-core route's arithmetic, chunk by chunk (model layout, q,
    k, v bf16): q·kᵀ of the bf16 values with f32 sums, masked before exp
    and decayed in f32; the f32 operands (the state, the scores P and
    exp(cum_C - cum_j)·v_j) as bf16 hi + lo; f32 sums; o rounded to bf16
    once."""
    b, s, h, dk = q.shape
    chunk = tref.chunk_for(s, chunk)
    st = state.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    outs = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        qi, ki, vi = (x[:, sl].float().transpose(1, 2) for x in (q, k, v))
        cum = torch.cumsum(log_g[:, sl].float().transpose(1, 2), dim=-1)
        total = cum[..., -1:]
        diff = torch.where(tri, cum[..., :, None] - cum[..., None, :],
                           float("-inf"))
        p = (qi @ ki.transpose(-1, -2)) * torch.exp(diff)
        o = torch.exp(cum)[..., None] * (qi @ _split(st)) + _split(p) @ vi
        vd = _split(torch.exp(total - cum)[..., None] * vi)
        st = torch.exp(total)[..., None] * st + ki.transpose(-1, -2) @ vd
        outs.append(o.transpose(1, 2))
    return torch.cat(outs, dim=1).bfloat16(), st


def _share(got, want, tol):
    atol, rtol = tol
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


@pytest.mark.parametrize("s,chunk,dk,dv,carried,g", [
    (1, 64, 16, 9, True, None),
    (37, 64, 32, 385, True, None),       # chunk = S; the ragged m-tile
    (128, 16, 16, 385, True, None),
    (128, 64, 32, 9, False, None),
    (128, 64, 32, 385, True, -30.0),
    (128, 16, 32, 9, True, -30.0)])
def test_mma_scan_arithmetic_stays_within_the_scan_tolerances(
        s, chunk, dk, dv, carried, g):
    """The tensor-core route's chunk arithmetic (``mma_scan_emulation``)
    against the f32 plain version on the same bf16 inputs: the state within
    half of ``TOL_SCAN``, the bf16 output within half of ``TOL_SCAN_BF16``
    (the hi + lo splits leave ~2^-17 of each f32 operand, far below one bf16
    ulp of o); and the f32 plain version against the JAX oracle where the
    oracle is finite (at log_g -30 its exp(cum_i - cum_j) overflows above
    the diagonal)."""
    rng = np.random.default_rng(s + dk + dv)
    b, h = 2, 2
    q = _t(_rand(rng, b, s, h, dk) * dk ** -0.5).bfloat16()
    k = _t(_rand(rng, b, s, h, dk)).bfloat16()
    v = _t(_rand(rng, b, s, h, dv)).bfloat16()
    lg = (-np.logaddexp(0.0, _rand(rng, b, s, h)) if g is None
          else np.full((b, s, h), g)).astype(np.float32)
    st = _rand(rng, b, h, dk, dv) if carried else np.zeros((b, h, dk, dv),
                                                          np.float32)
    log_g, state = _t(lg), _t(st)
    got = mma_scan_emulation(q, k, v, log_g, state, chunk)
    want = tref.ssm_scan(q, k, v, log_g, state, chunk=chunk)
    assert got[0].dtype == want[0].dtype == torch.bfloat16
    assert _share(got[0], want[0], TOL_SCAN_BF16) <= 0.5
    assert _share(got[1], want[1], TOL_SCAN) <= 0.5

    qf, kf, vf = (x.float() for x in (q, k, v))
    o, sf = tref.ssm_scan(qf, kf, vf, log_g, state, chunk=chunk)
    jo, jsf = (np.array(x) for x in jref.ssm_scan(
        *(jnp.asarray(x.numpy()) for x in (qf, kf, vf, log_g, state)),
        chunk=chunk))
    fin = np.isfinite(jo)
    assert fin.any() and (g is not None or fin.all())
    assert np.isfinite(jsf).all()
    assert _share(o[fin], _t(jo[fin]), TOL_SCAN) <= 1.0
    assert _share(sf, _t(jsf), TOL_SCAN) <= 1.0
