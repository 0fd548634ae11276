"""Triton source of the causal flash-attention kernels (Hopper).

Loaded by ``repro_torch.kernels.flash_attention`` at first launch; it
imports Triton at its top, so it lies outside the package's modules
(machines without Triton import the package). The design is in that
module's note. Shapes: q, k, v, dO read through their (b, s, h, hd)
strides; o, dq, dk, dv written (b, s, h, hd) contiguous; the log-sum-exp
and D (b, h, s) f32. HD is the head dim, HD_P its power-of-two padding.
"""
import triton
import triton.language as tl

LOG2E = tl.constexpr(1.4426950408889634)


@triton.jit
def _dot(a, b, acc, IEEE: tl.constexpr):
    if IEEE:
        acc = tl.dot(a, b, acc, input_precision="ieee")
    else:
        acc = tl.dot(a, b, acc)
    return acc


@triton.jit
def _tile(base, rows, s_stride, offs_d, d_stride, S, HD: tl.constexpr,
          HD_P: tl.constexpr, CHECK_ROWS: tl.constexpr):
    """A (rows, HD_P) tile; rows >= S (when checked) and columns >= HD
    read 0."""
    ptrs = base + rows[:, None] * s_stride + offs_d[None, :] * d_stride
    if CHECK_ROWS:
        if HD_P == HD:
            x = tl.load(ptrs, mask=rows[:, None] < S, other=0.0)
        else:
            x = tl.load(ptrs, mask=(rows[:, None] < S)
                        & (offs_d[None, :] < HD), other=0.0)
    else:
        if HD_P == HD:
            x = tl.load(ptrs)
        else:
            x = tl.load(ptrs, mask=offs_d[None, :] < HD, other=0.0)
    return x


@triton.jit
def _tile_t(base, rows, s_stride, offs_d, d_stride, S, HD: tl.constexpr,
            HD_P: tl.constexpr, CHECK_ROWS: tl.constexpr):
    """The transposed (HD_P, rows) tile."""
    ptrs = base + offs_d[:, None] * d_stride + rows[None, :] * s_stride
    if CHECK_ROWS:
        if HD_P == HD:
            x = tl.load(ptrs, mask=rows[None, :] < S, other=0.0)
        else:
            x = tl.load(ptrs, mask=(rows[None, :] < S)
                        & (offs_d[:, None] < HD), other=0.0)
    else:
        if HD_P == HD:
            x = tl.load(ptrs)
        else:
            x = tl.load(ptrs, mask=offs_d[:, None] < HD, other=0.0)
    return x


@triton.jit
def _store(base, rows, offs_d, val, S, H, HD: tl.constexpr,
           HD_P: tl.constexpr):
    """Rows < S of a (rows, HD_P) tile into a contiguous (s, h, hd)
    block."""
    ptrs = base + rows[:, None] * (H * HD) + offs_d[None, :]
    if HD_P == HD:
        tl.store(ptrs, val, mask=rows[:, None] < S)
    else:
        tl.store(ptrs, val, mask=(rows[:, None] < S) & (offs_d[None, :] < HD))


@triton.jit
def _fwd_tiles(acc, l_i, m_i, q, k_base, v_base, sks, skd, svs, svd, lo, hi,
               offs_m, offs_n, offs_d, S, qk_scale, HD: tl.constexpr,
               HD_P: tl.constexpr, BLOCK_M: tl.constexpr,
               BLOCK_N: tl.constexpr, DIAGONAL: tl.constexpr,
               IEEE: tl.constexpr):
    """The online softmax over the key tiles lo..hi: masked causally on
    the diagonal, whole below it."""
    for start_n in range(lo, hi, BLOCK_N):
        cols = start_n + offs_n
        kt = _tile_t(k_base, cols, sks, offs_d, skd, S, HD, HD_P, DIAGONAL)
        s = _dot(q, kt, tl.zeros([BLOCK_M, BLOCK_N], tl.float32), IEEE) \
            * qk_scale
        if DIAGONAL:
            s = tl.where(offs_m[:, None] >= cols[None, :], s, float("-inf"))
        m_new = tl.maximum(m_i, tl.max(s, 1))
        p = tl.math.exp2(s - m_new[:, None])
        alpha = tl.math.exp2(m_i - m_new)
        l_i = l_i * alpha + tl.sum(p, 1)
        v = _tile(v_base, cols, svs, offs_d, svd, S, HD, HD_P, DIAGONAL)
        acc = _dot(p.to(v.dtype), v, acc * alpha[:, None], IEEE)
        m_i = m_new
    return acc, l_i, m_i


@triton.jit
def flash_attn_fwd(Q, K, V, O, LSE, sqb, sqs, sqh, sqd, skb, sks, skh, skd,
                   svb, svs, svh, svd, H, S, qk_scale, HD: tl.constexpr,
                   HD_P: tl.constexpr, BLOCK_M: tl.constexpr,
                   BLOCK_N: tl.constexpr, IEEE: tl.constexpr):
    # The last query tiles walk the most key tiles: they start first.
    pid_m = tl.num_programs(0) - 1 - tl.program_id(0)
    bh = tl.program_id(1)
    b = (bh // H).to(tl.int64)
    h = (bh % H).to(tl.int64)
    start_m = pid_m * BLOCK_M
    offs_m = start_m + tl.arange(0, BLOCK_M)
    offs_n = tl.arange(0, BLOCK_N)
    offs_d = tl.arange(0, HD_P)
    q = _tile(Q + b * sqb + h * sqh, offs_m, sqs, offs_d, sqd, S, HD, HD_P,
              True)
    k_base = K + b * skb + h * skh
    v_base = V + b * svb + h * svh
    m_i = tl.full([BLOCK_M], float("-inf"), tl.float32)
    l_i = tl.zeros([BLOCK_M], tl.float32)
    acc = tl.zeros([BLOCK_M, HD_P], tl.float32)
    acc, l_i, m_i = _fwd_tiles(acc, l_i, m_i, q, k_base, v_base, sks, skd,
                               svs, svd, 0, start_m, offs_m, offs_n, offs_d,
                               S, qk_scale, HD, HD_P, BLOCK_M, BLOCK_N,
                               False, IEEE)
    acc, l_i, m_i = _fwd_tiles(acc, l_i, m_i, q, k_base, v_base, sks, skd,
                               svs, svd, start_m,
                               tl.minimum(start_m + BLOCK_M, S), offs_m,
                               offs_n, offs_d, S, qk_scale, HD, HD_P, BLOCK_M,
                               BLOCK_N, True, IEEE)
    acc = acc / l_i[:, None]
    _store(O + b * S * H * HD + h * HD, offs_m, offs_d,
           acc.to(O.dtype.element_ty), S, H, HD, HD_P)
    lse = (m_i + tl.math.log2(l_i)) / LOG2E
    tl.store(LSE + bh.to(tl.int64) * S + offs_m, lse, mask=offs_m < S)


@triton.jit
def flash_attn_bwd_delta(O, DO, DELTA, sdob, sdos, sdoh, sdod, H, S,
                         HD: tl.constexpr, HD_P: tl.constexpr,
                         BLOCK_M: tl.constexpr):
    bh = tl.program_id(1)
    b = (bh // H).to(tl.int64)
    h = (bh % H).to(tl.int64)
    offs_m = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
    offs_d = tl.arange(0, HD_P)
    o = _tile(O + b * S * H * HD + h * HD, offs_m, H * HD, offs_d, 1, S, HD,
              HD_P, True)
    do = _tile(DO + b * sdob + h * sdoh, offs_m, sdos, offs_d, sdod, S, HD,
               HD_P, True)
    delta = tl.sum(o.to(tl.float32) * do.to(tl.float32), 1)
    tl.store(DELTA + bh.to(tl.int64) * S + offs_m, delta, mask=offs_m < S)


@triton.jit
def _dkdv_tiles(dk, dv, k, v, q_base, do_base, lse_ptr, delta_ptr, sqs, sqd,
                sdos, sdod, lo, hi, offs_n, offs_m0, offs_d, S, qk_scale,
                HD: tl.constexpr, HD_P: tl.constexpr, BLOCK_M: tl.constexpr,
                BLOCK_N: tl.constexpr, DIAGONAL: tl.constexpr,
                IEEE: tl.constexpr):
    """dK and dV of one key tile over the query tiles lo..hi, P rebuilt
    from the log-sum-exp (transposed: keys are rows here)."""
    for start_m in range(lo, hi, BLOCK_M):
        rows = start_m + offs_m0
        qt = _tile_t(q_base, rows, sqs, offs_d, sqd, S, HD, HD_P, True)
        # Query rows past the end read an infinite log-sum-exp: P = 0.
        lse = tl.load(lse_ptr + rows, mask=rows < S,
                      other=float("inf")) * LOG2E
        s_t = _dot(k, qt, tl.zeros([BLOCK_N, BLOCK_M], tl.float32), IEEE) \
            * qk_scale
        p_t = tl.math.exp2(s_t - lse[None, :])
        if DIAGONAL:
            p_t = tl.where(rows[None, :] >= offs_n[:, None], p_t, 0.0)
        do = _tile(do_base, rows, sdos, offs_d, sdod, S, HD, HD_P, True)
        dv = _dot(p_t.to(do.dtype), do, dv, IEEE)
        dp_t = _dot(v, tl.trans(do), tl.zeros([BLOCK_N, BLOCK_M], tl.float32),
                    IEEE)
        d = tl.load(delta_ptr + rows, mask=rows < S, other=0.0)
        ds_t = p_t * (dp_t - d[None, :])
        dk = _dot(ds_t.to(qt.dtype), tl.trans(qt), dk, IEEE)
    return dk, dv


@triton.jit
def flash_attn_bwd_dkdv(Q, K, V, DO, LSE, DELTA, DK, DV, sqb, sqs, sqh, sqd,
                        skb, sks, skh, skd, svb, svs, svh, svd, sdob, sdos,
                        sdoh, sdod, H, S, qk_scale, sm_scale,
                        HD: tl.constexpr, HD_P: tl.constexpr,
                        BLOCK_M: tl.constexpr, BLOCK_N: tl.constexpr,
                        IEEE: tl.constexpr):
    bh = tl.program_id(1)
    b = (bh // H).to(tl.int64)
    h = (bh % H).to(tl.int64)
    start_n = tl.program_id(0) * BLOCK_N
    offs_n = start_n + tl.arange(0, BLOCK_N)
    offs_m0 = tl.arange(0, BLOCK_M)
    offs_d = tl.arange(0, HD_P)
    k = _tile(K + b * skb + h * skh, offs_n, sks, offs_d, skd, S, HD, HD_P,
              True)
    v = _tile(V + b * svb + h * svh, offs_n, svs, offs_d, svd, S, HD, HD_P,
              True)
    q_base = Q + b * sqb + h * sqh
    do_base = DO + b * sdob + h * sdoh
    lse_ptr = LSE + bh.to(tl.int64) * S
    delta_ptr = DELTA + bh.to(tl.int64) * S
    dk = tl.zeros([BLOCK_N, HD_P], tl.float32)
    dv = tl.zeros([BLOCK_N, HD_P], tl.float32)
    # The query tiles on the diagonal, then those wholly below it.
    dk, dv = _dkdv_tiles(dk, dv, k, v, q_base, do_base, lse_ptr, delta_ptr,
                         sqs, sqd, sdos, sdod, start_n,
                         tl.minimum(start_n + BLOCK_N, S), offs_n, offs_m0,
                         offs_d, S, qk_scale, HD, HD_P, BLOCK_M, BLOCK_N,
                         True, IEEE)
    dk, dv = _dkdv_tiles(dk, dv, k, v, q_base, do_base, lse_ptr, delta_ptr,
                         sqs, sqd, sdos, sdod, start_n + BLOCK_N, S, offs_n,
                         offs_m0, offs_d, S, qk_scale, HD, HD_P, BLOCK_M,
                         BLOCK_N, False, IEEE)
    out = b * S * H * HD + h * HD
    _store(DK + out, offs_n, offs_d, (dk * sm_scale).to(DK.dtype.element_ty),
           S, H, HD, HD_P)
    _store(DV + out, offs_n, offs_d, dv.to(DV.dtype.element_ty), S, H, HD,
           HD_P)


@triton.jit
def _dq_tiles(dq, q, do, lse, d, k_base, v_base, sks, skd, svs, svd, lo, hi,
              offs_m, offs_n0, offs_d, S, qk_scale, HD: tl.constexpr,
              HD_P: tl.constexpr, BLOCK_M: tl.constexpr,
              BLOCK_N: tl.constexpr, DIAGONAL: tl.constexpr,
              IEEE: tl.constexpr):
    """dQ of one query tile over the key tiles lo..hi."""
    for start_n in range(lo, hi, BLOCK_N):
        cols = start_n + offs_n0
        kt = _tile_t(k_base, cols, sks, offs_d, skd, S, HD, HD_P, DIAGONAL)
        vt = _tile_t(v_base, cols, svs, offs_d, svd, S, HD, HD_P, DIAGONAL)
        s = _dot(q, kt, tl.zeros([BLOCK_M, BLOCK_N], tl.float32), IEEE) \
            * qk_scale
        p = tl.math.exp2(s - lse[:, None])
        if DIAGONAL:
            p = tl.where(offs_m[:, None] >= cols[None, :], p, 0.0)
        dp = _dot(do, vt, tl.zeros([BLOCK_M, BLOCK_N], tl.float32), IEEE)
        ds = p * (dp - d[:, None])
        dq = _dot(ds.to(kt.dtype), tl.trans(kt), dq, IEEE)
    return dq


@triton.jit
def flash_attn_bwd_dq(Q, K, V, DO, LSE, DELTA, DQ, sqb, sqs, sqh, sqd, skb,
                      sks, skh, skd, svb, svs, svh, svd, sdob, sdos, sdoh,
                      sdod, H, S, qk_scale, sm_scale, HD: tl.constexpr,
                      HD_P: tl.constexpr, BLOCK_M: tl.constexpr,
                      BLOCK_N: tl.constexpr, IEEE: tl.constexpr):
    pid_m = tl.num_programs(0) - 1 - tl.program_id(0)
    bh = tl.program_id(1)
    b = (bh // H).to(tl.int64)
    h = (bh % H).to(tl.int64)
    start_m = pid_m * BLOCK_M
    offs_m = start_m + tl.arange(0, BLOCK_M)
    offs_n0 = tl.arange(0, BLOCK_N)
    offs_d = tl.arange(0, HD_P)
    q = _tile(Q + b * sqb + h * sqh, offs_m, sqs, offs_d, sqd, S, HD, HD_P,
              True)
    do = _tile(DO + b * sdob + h * sdoh, offs_m, sdos, offs_d, sdod, S, HD,
               HD_P, True)
    lse = tl.load(LSE + bh.to(tl.int64) * S + offs_m, mask=offs_m < S,
                  other=float("inf")) * LOG2E
    d = tl.load(DELTA + bh.to(tl.int64) * S + offs_m, mask=offs_m < S,
                other=0.0)
    k_base = K + b * skb + h * skh
    v_base = V + b * svb + h * svh
    dq = tl.zeros([BLOCK_M, HD_P], tl.float32)
    dq = _dq_tiles(dq, q, do, lse, d, k_base, v_base, sks, skd, svs, svd, 0,
                   start_m, offs_m, offs_n0, offs_d, S, qk_scale, HD, HD_P,
                   BLOCK_M, BLOCK_N, False, IEEE)
    dq = _dq_tiles(dq, q, do, lse, d, k_base, v_base, sks, skd, svs, svd,
                   start_m, tl.minimum(start_m + BLOCK_M, S), offs_m,
                   offs_n0, offs_d, S, qk_scale, HD, HD_P, BLOCK_M, BLOCK_N,
                   True, IEEE)
    _store(DQ + b * S * H * HD + h * HD, offs_m, offs_d,
           (dq * sm_scale).to(DQ.dtype.element_ty), S, H, HD, HD_P)
