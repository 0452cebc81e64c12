"""Wavefront alignment (WFA) kernels: O(ns) score-only alignment on device.

The reference ships WFA2-lib as its intended fast engine but never wires it
in (SURVEY 2.9: only .o artifacts remain, no FFI call sites). We implement
the wavefront algorithm (Marco-Sola et al.) as batched JAX device code:

- diagonals k = h - v (h = reference index, v = read index), offset = h;
- per score s, the furthest-reaching offsets advance by greedy match
  extension, then new wavefronts combine from s - x (mismatch),
  s - o - e (gap open), s - e (gap extend);
- the whole batch advances one score step per `lax.while_loop` iteration,
  each a [B, K] vector op - active lanes are the |k| <= s band, so total
  work is O(sum_b s_b * s_b) instead of the DP's O(B * n * m).

Edit-distance (`wfa_edit_batch`) and gap-affine (`wfa_affine_batch`)
penalties are provided; both are score-only (the collapse distance kernels
and HiFi verification paths need scores, not tracebacks - bit-compat
traceback stays with align/batch.py). Greedy extension advances one
character per inner iteration across all lanes, exiting as soon as no lane
can extend, so the inner loop runs ~(longest current run) times.

On WFA2-lib's component set (SURVEY 2.9):
- dual-affine ("convex") penalties: wfa_affine2p_batch / _tb_batch
  (wavefront_compute_affine2p.o);
- gap-linear penalties: wfa_linear_batch (wavefront_compute_linear.o);
- adaptive heuristics (wavefront_heuristic.o) map here to BAND
  reduction, which shrinks the static [B, K] tensor shapes (masking
  lanes would save nothing, but a smaller K does): every kernel first
  applies the EXACT band |k| <= (smax - o) / e (exact_kband - zero
  accuracy loss), and the `kband` argument opts into the narrower
  heuristic band with WfaAligner retrying censored pairs unbanded
  (score cutoffs are the s0/2x-escalation ladder in WfaAligner);
- the low-memory bialign (wavefront_bialign.o) is wfa_bialign_affine_pairs:
  a midpoint-carry formulation (wfa_affine_mid_batch threads the last
  on-path M-state cell at/before the middle anti-diagonal through the
  recurrence as an int32 payload — O(B*K) memory, no op store at all),
  then recurses on the two halves until segments are small enough for
  the direct traceback kernel. WFA2's version meets forward and reverse
  wavefronts; carrying the breakpoint forward is the batched
  equivalent (one batched sweep per level, no lockstep host mediation).
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = jnp.int32(-(1 << 30))


def _is_wild(c):
    return (c < 58) | (c == 78)


def exact_kband(smax: int, opens_extends) -> int:
    """Largest |diagonal| any path with penalty <= smax can touch.

    Reaching diagonal k requires |k| net indels, whose minimal cost over
    the gap classes is min_i(o_i + e_i * |k|); inverting gives the exact
    diagonal bound — every wavefront tensor shrinks from K = 2*smax+1 to
    2*kband+1 with ZERO accuracy loss (unlike wavefront_heuristic.o's
    band reduction, which may drop optimal paths; that heuristic mode is
    the opt-in `kband` argument on the kernels)."""
    kb = 0
    for o, e in opens_extends:
        if smax > o:
            kb = max(kb, (smax - o) // max(e, 1))
    return kb


def _run_table(refs_i, reads_i, ks, l1, l2, wildcards: bool = False):
    """Packed greedy-extension tables: per (lane, diagonal), a 32x-packed
    match BITMAP over offsets plus a word-run table of consecutive
    all-match words.

    The naive extension loop advances one character per `while_loop`
    iteration with a [B, K] gather per check; this design avoids per-step
    dynamic gathers (a choice not yet re-measured on the H100). An
    unpacked [B, K, H] run-length table would stream the whole table
    from device memory every score step (196MB at B=1024, L=512). The
    bitmap form is 16x smaller: each extension
    reads [B, K, W=ceil(H/32)] words via one-hot lane reductions and
    counts leading matches with popcount arithmetic (_table_extend).

    Returns (bits [B, K, W] uint32 — bit j of word w = match at offset
    32w+j; wordrun [B, K, W] int32 — consecutive all-match words from w).
    """
    B, n1w = refs_i.shape
    n2w = reads_i.shape[1]
    K = ks.shape[0]
    H = n1w + 1                                   # offsets 0..n1w
    h = jnp.arange(H, dtype=jnp.int32)
    v = h[None, :] - ks[:, None]                  # [K, H]
    rv = jnp.take(reads_i, jnp.clip(v, 0, n2w - 1), axis=1)   # [B, K, H]
    rh = jnp.take(refs_i, jnp.clip(h, 0, n1w - 1), axis=1)    # [B, H]
    rh = rh[:, None, :]
    eq = rh == rv
    if wildcards:
        eq = eq | _is_wild(rh) | _is_wild(rv)
    l1b = l1[:, 0][:, None, None]
    l2b = l2[:, 0][:, None, None]
    ok = (h[None, None, :] < l1b) & (v[None, :, :] >= 0) & \
        (v[None, :, :] < l2b)
    eq = eq & ok
    W = (H + 31) // 32
    eqp = jnp.pad(eq, ((0, 0), (0, 0), (0, W * 32 - H)))
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    bits = jnp.sum(eqp.reshape(B, K, W, 32).astype(jnp.uint32)
                   * weights, axis=3, dtype=jnp.uint32)
    full = bits == jnp.uint32(0xFFFFFFFF)
    iw = jnp.arange(W, dtype=jnp.int32)
    z = jnp.where(full, jnp.int32(W), iw[None, None, :])
    nz = jnp.flip(jax.lax.cummin(jnp.flip(z, axis=-1), axis=2), axis=-1)
    wordrun = nz - iw[None, None, :]
    # word runs <= W <= 1024 for any representable pair; u16 quarters the
    # per-step stream (the extend loop reads this table every score step)
    return bits, wordrun.astype(jnp.uint16)


def _ctz32(x):
    """Count trailing zeros of a uint32 (32 for x == 0)."""
    low = x & (jnp.uint32(0) - x)
    return jax.lax.population_count(low - jnp.uint32(1))


def _table_extend(offsets, run, valid, n1w: int):
    """Greedy extension against the packed _run_table: one-hot word
    selects instead of gathers (iota-compare + sum; not yet re-measured
    against a gather on the H100) + popcount trailing-ones arithmetic.
    A run is
    (matches to the end of the starting word) + 32 * (consecutive
    all-match words) + (leading matches of the word after)."""
    bits, wordrun = run
    ok = valid & (offsets > NEG) & (offsets >= 0)
    offc = jnp.clip(offsets, 0, n1w)
    w0 = offc >> 5
    b0 = (offc & 31).astype(jnp.uint32)
    W = bits.shape[2]
    iw = jnp.arange(W, dtype=jnp.int32)[None, None, :]
    sel0 = iw == w0[:, :, None]
    word0 = jnp.sum(jnp.where(sel0, bits, jnp.uint32(0)), axis=2,
                    dtype=jnp.uint32)
    rem = word0 >> b0                 # matches from offset, LSB-aligned
    full_tail = rem == (jnp.uint32(0xFFFFFFFF) >> b0)
    c0 = _ctz32(~rem).astype(jnp.int32)
    # tail ran to the word end: add full words + the next word's prefix
    w1a = w0 + 1
    sel1a = iw == w1a[:, :, None]
    wr = jnp.sum(jnp.where(sel1a, wordrun, jnp.uint16(0)).astype(jnp.int32),
                 axis=2)
    w1 = w1a + wr
    sel1 = iw == w1[:, :, None]
    word1 = jnp.sum(jnp.where(sel1, bits, jnp.uint32(0)), axis=2,
                    dtype=jnp.uint32)
    c1 = _ctz32(~word1).astype(jnp.int32)
    ext2 = (jnp.int32(32) - b0.astype(jnp.int32)) + 32 * wr + c1
    ext = jnp.where(full_tail, ext2, c0)
    return jnp.where(ok, offsets + ext, offsets)


@functools.partial(jax.jit, static_argnames=("n1", "n2", "smax"))
def wfa_edit_batch(refs, reads, ref_lens, read_lens, *, n1: int, n2: int,
                   smax: int):
    """Batched WFA edit distance. Returns [B] i32 (smax + 1 if censored).

    Diagonals clamped to |k| <= smax (see wfa_affine_batch)."""
    B = refs.shape[0]
    Kmax = min(n1 + n2, smax)  # |k| bound
    K = 2 * Kmax + 1
    ks = jnp.arange(K, dtype=jnp.int32) - Kmax

    refs_i = refs.astype(jnp.int32)
    reads_i = reads.astype(jnp.int32)
    l1 = ref_lens[:, None].astype(jnp.int32)
    l2 = read_lens[:, None].astype(jnp.int32)
    k_target = (l1 - l2)[:, 0]
    target_ok = jnp.abs(k_target) <= Kmax
    k_target = jnp.clip(k_target, -Kmax, Kmax)

    def diag_valid(s):
        return (jnp.abs(ks)[None, :] <= s) & \
            (ks[None, :] >= -l2) & (ks[None, :] <= l1)

    n1w = refs_i.shape[1]
    run = _run_table(refs_i, reads_i, ks, l1, l2)
    m0 = jnp.where((ks == 0)[None, :] & jnp.ones((B, 1), bool), 0, NEG)
    m0 = _table_extend(m0, run, diag_valid(0), n1w)

    tgt_mask = ks[None, :] == k_target[:, None]

    def done(m):
        # fixed one-hot mask + max instead of a per-step gather (see
        # _table_extend)
        tgt = jnp.max(jnp.where(tgt_mask, m, NEG), axis=1)
        return target_ok & (tgt >= l1[:, 0])

    def cond(state):
        s, m, result = state
        return (s < smax) & jnp.logical_not(jnp.all(result >= 0))

    def body(state):
        s, m, result = state
        s1 = s + 1
        # M_{s+1}[k] = max(M_s[k] + 1, M_s[k-1] + 1, M_s[k+1])
        from_same = jnp.where(m > NEG, m + 1, NEG)
        shift_r = jnp.pad(m[:, :-1], ((0, 0), (1, 0)), constant_values=NEG)
        from_del = jnp.where(shift_r > NEG, shift_r + 1, NEG)
        from_ins = jnp.pad(m[:, 1:], ((0, 0), (0, 1)), constant_values=NEG)
        new = jnp.maximum(from_same, jnp.maximum(from_del, from_ins))
        vld = diag_valid(s1)
        new = jnp.where(vld, new, NEG)
        # clamp to the rectangle
        v = new - ks[None, :]
        new = jnp.where((new <= l1) & (v <= l2), new, NEG)
        new = _table_extend(new, run, vld, n1w)
        result = jnp.where((result < 0) & done(new), s1, result)
        return s1, new, result

    init_result = jnp.where(done(m0), 0, -1)
    s, m, result = jax.lax.while_loop(cond, body,
                                      (jnp.int32(0), m0, init_result))
    return jnp.where(result < 0, smax + 1, result)


@functools.partial(jax.jit,
                   static_argnames=("n1", "n2", "smax", "x", "e",
                                    "wildcards", "kband"))
def wfa_linear_batch(refs, reads, ref_lens, read_lens, *, n1: int, n2: int,
                     smax: int, x: int = 4, e: int = 2,
                     wildcards: bool = False, kband: Optional[int] = None):
    """Batched gap-LINEAR WFA (WFA2-lib's wavefront_compute_linear.o,
    SURVEY 2.9): penalties mismatch=x, per-base indel=e, no gap-open term,
    so only the M plane exists and the lookbacks are s-x (mismatch) and
    s-e (indel from either neighbor diagonal). Returns the minimal
    penalty [B] i32 (smax + 1 censored). Edit distance is the x=e=1
    special case (wfa_edit_batch keeps its leaner loop)."""
    B = refs.shape[0]
    Kmax = min(n1 + n2, smax, smax // max(e, 1))
    if kband is not None:
        Kmax = min(Kmax, kband)
    K = 2 * Kmax + 1
    ks = jnp.arange(K, dtype=jnp.int32) - Kmax
    hist = max(x, e) + 1

    refs_i = refs.astype(jnp.int32)
    reads_i = reads.astype(jnp.int32)
    l1 = ref_lens[:, None].astype(jnp.int32)
    l2 = read_lens[:, None].astype(jnp.int32)
    k_target = (l1 - l2)[:, 0]
    target_ok = jnp.abs(k_target) <= Kmax
    k_target = jnp.clip(k_target, -Kmax, Kmax)

    def clamp(offs):
        v = offs - ks[None, :]
        return jnp.where((offs <= l1) & (v <= l2) & (v >= 0) &
                         (ks[None, :] >= -l2) & (ks[None, :] <= l1),
                         offs, NEG)

    def diag_valid(s):
        return (jnp.abs(ks)[None, :] <= s) & \
            (ks[None, :] >= -l2) & (ks[None, :] <= l1)

    neg_wf = jnp.full((B, K), NEG, jnp.int32)
    n1w = refs_i.shape[1]
    run = _run_table(refs_i, reads_i, ks, l1, l2, wildcards=wildcards)
    m0 = jnp.where((ks == 0)[None, :] & jnp.ones((B, 1), bool), 0, NEG)
    m0 = _table_extend(m0, run, diag_valid(0), n1w)

    M = jnp.full((hist, B, K), NEG, jnp.int32).at[0].set(m0)

    def get_from(buf, s, back):
        ok = s - back >= 0
        return jnp.where(ok, buf[(s - back) % hist], neg_wf)

    tgt_mask = ks[None, :] == k_target[:, None]

    def done(m):
        # fixed one-hot mask + max instead of a per-step gather (see
        # _table_extend)
        tgt = jnp.max(jnp.where(tgt_mask, m, NEG), axis=1)
        return target_ok & (tgt >= l1[:, 0])

    def cond(state):
        s, M, result = state
        return (s < smax) & jnp.logical_not(jnp.all(result >= 0))

    def body(state):
        s, M_, result = state
        s1 = s + 1
        m_x = get_from(M_, s1, x)
        m_e = get_from(M_, s1, e)
        mism = jnp.where(m_x > NEG, m_x + 1, NEG)
        from_del = jnp.pad(m_e[:, :-1], ((0, 0), (1, 0)),
                           constant_values=NEG)
        from_del = jnp.where(from_del > NEG, from_del + 1, NEG)
        from_ins = jnp.pad(m_e[:, 1:], ((0, 0), (0, 1)),
                           constant_values=NEG)
        new = jnp.maximum(mism, jnp.maximum(from_del, from_ins))
        vld = diag_valid(s1)
        new = clamp(jnp.where(vld, new, NEG))
        new = _table_extend(new, run, vld, n1w)
        M_ = M_.at[s1 % hist].set(new)
        result = jnp.where((result < 0) & done(new), s1, result)
        return s1, M_, result

    init_result = jnp.where(done(m0), 0, -1)
    s, M, result = jax.lax.while_loop(cond, body,
                                      (jnp.int32(0), M, init_result))
    return jnp.where(result < 0, smax + 1, result)


@functools.partial(jax.jit,
                   static_argnames=("n1", "n2", "smax", "x", "o", "e",
                                    "wildcards", "kband"))
def wfa_affine_batch(refs, reads, ref_lens, read_lens, *, n1: int, n2: int,
                     smax: int, x: int = 4, o: int = 6, e: int = 2,
                     wildcards: bool = False, kband: Optional[int] = None):
    """Batched gap-affine WFA: penalties mismatch=x, gap open=o, extend=e
    (match = 0). Returns the alignment penalty [B] i32 (smax+1 censored).

    Keeps a ring of the last `hist` wavefronts for the s-x / s-o-e / s-e
    lookbacks. Diagonals are clamped to the EXACT band |k| <=
    (smax - o) // e (exact_kband: touching diagonal k costs at least
    o + e*|k|, so wider diagonals censor identically while every tensor
    shrinks ~e-fold). kband further narrows the band heuristically
    (wavefront_heuristic.o's band reduction: may censor in-band-cost
    paths that wander wider; callers escalate on censor).
    wildcards=True makes digit/N bytes extend as matches
    (scoring_functions.rs:100-102's special-character rule)."""
    B = refs.shape[0]
    Kmax = min(n1 + n2, smax, exact_kband(smax, ((o, e),)))
    if kband is not None:
        Kmax = min(Kmax, kband)
    K = 2 * Kmax + 1
    ks = jnp.arange(K, dtype=jnp.int32) - Kmax
    hist = max(x, o + e, e) + 1

    refs_i = refs.astype(jnp.int32)
    reads_i = reads.astype(jnp.int32)
    l1 = ref_lens[:, None].astype(jnp.int32)
    l2 = read_lens[:, None].astype(jnp.int32)
    k_target = (l1 - l2)[:, 0]
    target_ok = jnp.abs(k_target) <= Kmax
    k_target = jnp.clip(k_target, -Kmax, Kmax)

    def clamp(offs):
        v = offs - ks[None, :]
        return jnp.where((offs <= l1) & (v <= l2) & (v >= 0) &
                         (ks[None, :] >= -l2) & (ks[None, :] <= l1),
                         offs, NEG)

    def diag_valid(s):
        return (jnp.abs(ks)[None, :] <= s) & \
            (ks[None, :] >= -l2) & (ks[None, :] <= l1)

    neg_wf = jnp.full((B, K), NEG, jnp.int32)
    n1w = refs_i.shape[1]
    run = _run_table(refs_i, reads_i, ks, l1, l2, wildcards=wildcards)
    m0 = jnp.where((ks == 0)[None, :] & jnp.ones((B, 1), bool), 0, NEG)
    m0 = _table_extend(m0, run, diag_valid(0), n1w)

    # ring buffers [hist, B, K] for M, I, D; index s % hist
    M = jnp.full((hist, B, K), NEG, jnp.int32).at[0].set(m0)
    I = jnp.full((hist, B, K), NEG, jnp.int32)
    D = jnp.full((hist, B, K), NEG, jnp.int32)

    def get(buf, s, back):
        idx = (s - back) % hist
        ok = s - back >= 0
        return jnp.where(ok, buf[idx], neg_wf)

    tgt_mask = ks[None, :] == k_target[:, None]

    def done(m):
        # fixed one-hot mask + max instead of a per-step gather (see
        # _table_extend)
        tgt = jnp.max(jnp.where(tgt_mask, m, NEG), axis=1)
        return target_ok & (tgt >= l1[:, 0])

    def cond(state):
        s, M, I, D, result = state
        return (s < smax) & jnp.logical_not(jnp.all(result >= 0))

    def body(state):
        s, M, I, D, result = state
        s1 = s + 1

        def sr(w):  # from diagonal k-1 (deletion direction, h+1)
            return jnp.pad(w[:, :-1], ((0, 0), (1, 0)), constant_values=NEG)

        def sl(w):  # from diagonal k+1 (insertion direction)
            return jnp.pad(w[:, 1:], ((0, 0), (0, 1)), constant_values=NEG)

        m_oe = get(M, s1, o + e)
        i_e = get(I, s1, e)
        d_e = get(D, s1, e)
        m_x = get(M, s1, x)

        new_d = jnp.maximum(sr(m_oe), sr(d_e))
        new_d = jnp.where(new_d > NEG, new_d + 1, NEG)
        new_i = jnp.maximum(sl(m_oe), sl(i_e))
        mism = jnp.where(m_x > NEG, m_x + 1, NEG)
        new_m = jnp.maximum(mism, jnp.maximum(new_i, new_d))
        vld = diag_valid(s1)
        new_m = clamp(jnp.where(vld, new_m, NEG))
        new_i = clamp(jnp.where(vld, new_i, NEG))
        new_d = clamp(jnp.where(vld, new_d, NEG))
        new_m = _table_extend(new_m, run, vld, n1w)

        idx = s1 % hist
        M = M.at[idx].set(new_m)
        I = I.at[idx].set(new_i)
        D = D.at[idx].set(new_d)
        result = jnp.where((result < 0) & done(new_m), s1, result)
        return s1, M, I, D, result

    init_result = jnp.where(done(m0), 0, -1)
    s, M, I, D, result = jax.lax.while_loop(
        cond, body, (jnp.int32(0), M, I, D, init_result))
    return jnp.where(result < 0, smax + 1, result)


_MID_ENC = 1 << 16  # payload encoding: h * _MID_ENC + v (lengths < 32768)


def _bialign_len_ok(n: int) -> bool:
    """True when a pair of max raw length n fits the bialign split
    encoding. _mid_split_batch quantizes lengths UP to a 128 multiple and
    rejects quantized >= _MID_ENC//2, so the routing guard must bound the
    QUANTIZED length: raw 32641..32767 quantizes to 32768 and would crash
    the split driver despite passing a raw `< 32768` check."""
    return -(-max(n, 1) // 128) * 128 < _MID_ENC // 2


@functools.partial(jax.jit,
                   static_argnames=("n1", "n2", "smax", "x", "o", "e",
                                    "wildcards", "kband"))
def wfa_affine_mid_batch(refs, reads, ref_lens, read_lens, *, n1: int,
                         n2: int, smax: int, x: int = 4, o: int = 6,
                         e: int = 2, wildcards: bool = False,
                         kband: Optional[int] = None):
    """Gap-affine WFA score kernel that also reports a SPLIT POINT: the
    last M-state cell (h, v) with anti-diagonal h + v <= (l1 + l2) // 2 on
    an optimal path — the breakpoint wavefront_bialign.o finds by meeting
    forward/reverse wavefronts (SURVEY 2.9). Memory is O(B*K) (the score
    rings plus three int32 payload rings), NOT the O(smax*B*K) op store of
    the traceback kernel, so arbitrarily divergent/long pairs fit.

    The payload propagates through the recurrence exactly like the
    traceback choice (tie orders mirror wfa_affine_tb_batch: mismatch >
    I > D; gap tie -> open), and greedy match extension advances it to
    min(run end, the last in-run offset whose anti-diagonal is still
    <= mid). Anti-diagonals strictly increase along any path, so the
    recorded cell is unique per path and splitting there is exact: both
    halves are standard global sub-alignments whose optimal penalties sum
    to the pair's optimum (the junction is an M-state cell, so no gap run
    is double-opened *on the recorded path*; co-optimal re-opened gaps in
    the halves only ever re-merge cheaper).

    Returns (penalty [B] i32 (smax+1 censored), payload [B] i32 encoding
    h * 65536 + v, -1 when censored)."""
    B = refs.shape[0]
    Kmax = min(n1 + n2, smax, exact_kband(smax, ((o, e),)))
    if kband is not None:
        Kmax = min(Kmax, kband)
    K = 2 * Kmax + 1
    ks = jnp.arange(K, dtype=jnp.int32) - Kmax
    hist = max(x, o + e, e) + 1

    refs_i = refs.astype(jnp.int32)
    reads_i = reads.astype(jnp.int32)
    l1 = ref_lens[:, None].astype(jnp.int32)
    l2 = read_lens[:, None].astype(jnp.int32)
    mid = (l1 + l2) // 2                       # [B, 1] anti-diagonal split
    k_target = (l1 - l2)[:, 0]
    target_ok = jnp.abs(k_target) <= Kmax
    k_target_c = jnp.clip(k_target, -Kmax, Kmax)

    def clamp(offs):
        v = offs - ks[None, :]
        return jnp.where((offs <= l1) & (v <= l2) & (v >= 0) &
                         (ks[None, :] >= -l2) & (ks[None, :] <= l1),
                         offs, NEG)

    def diag_valid(s):
        return (jnp.abs(ks)[None, :] <= s) & \
            (ks[None, :] >= -l2) & (ks[None, :] <= l1)

    neg_wf = jnp.full((B, K), NEG, jnp.int32)
    neg_pay = jnp.full((B, K), -1, jnp.int32)
    n1w = refs_i.shape[1]
    run = _run_table(refs_i, reads_i, ks, l1, l2, wildcards=wildcards)

    def pay_update(h_base, h_ext, pay_inh):
        """Advance a payload across one M step + greedy extension: the run
        of M cells h_base..h_ext on diagonal k contains the path's newest
        cells; pick the last one still at/before the mid anti-diagonal."""
        cand = jnp.clip((mid + ks[None, :]) >> 1, h_base, h_ext)
        on_mid = (h_base > NEG) & (2 * cand - ks[None, :] <= mid)
        return jnp.where(on_mid, cand * _MID_ENC + (cand - ks[None, :]),
                         pay_inh)

    m0_base = jnp.where((ks == 0)[None, :] & jnp.ones((B, 1), bool), 0, NEG)
    m0 = _table_extend(m0_base, run, diag_valid(0), n1w)
    p0 = pay_update(m0_base, m0, neg_pay)

    M = jnp.full((hist, B, K), NEG, jnp.int32).at[0].set(m0)
    I = jnp.full((hist, B, K), NEG, jnp.int32)
    D = jnp.full((hist, B, K), NEG, jnp.int32)
    PM = jnp.full((hist, B, K), -1, jnp.int32).at[0].set(p0)
    PI = jnp.full((hist, B, K), -1, jnp.int32)
    PD = jnp.full((hist, B, K), -1, jnp.int32)

    def get(buf, s, back):
        idx = (s - back) % hist
        ok = s - back >= 0
        return jnp.where(ok, buf[idx], neg_wf)

    def getp(buf, s, back):
        idx = (s - back) % hist
        ok = s - back >= 0
        return jnp.where(ok, buf[idx], neg_pay)

    tgt_mask = ks[None, :] == k_target_c[:, None]

    def done(m):
        tgt = jnp.max(jnp.where(tgt_mask, m, NEG), axis=1)
        return target_ok & (tgt >= l1[:, 0])

    def cond(state):
        s = state[0]
        result = state[-2]
        return (s < smax) & jnp.logical_not(jnp.all(result >= 0))

    def body(state):
        s, M, I, D, PM, PI, PD, result, out_pay = state
        s1 = s + 1

        def sr(w):  # deletion direction: W[k-1], h+1
            return jnp.pad(w[:, :-1], ((0, 0), (1, 0)), constant_values=NEG)

        def sl(w):  # insertion direction: W[k+1], h unchanged
            return jnp.pad(w[:, 1:], ((0, 0), (0, 1)), constant_values=NEG)

        def srp(w):
            return jnp.pad(w[:, :-1], ((0, 0), (1, 0)), constant_values=-1)

        def slp(w):
            return jnp.pad(w[:, 1:], ((0, 0), (0, 1)), constant_values=-1)

        m_oe = get(M, s1, o + e)
        i_e = get(I, s1, e)
        d_e = get(D, s1, e)
        m_x = get(M, s1, x)
        p_oe = getp(PM, s1, o + e)
        pi_e = getp(PI, s1, e)
        pd_e = getp(PD, s1, e)
        p_x = getp(PM, s1, x)

        d_open = sr(m_oe)
        d_ext = sr(d_e)
        new_d = jnp.maximum(d_open, d_ext)
        d_from_ext = d_ext > d_open            # tie -> open (as in tb)
        pay_d = jnp.where(d_from_ext, srp(pd_e), srp(p_oe))
        new_d = jnp.where(new_d > NEG, new_d + 1, NEG)
        i_open = sl(m_oe)
        i_ext = sl(i_e)
        new_i = jnp.maximum(i_open, i_ext)
        pay_i = jnp.where(i_ext > i_open, slp(pi_e), slp(p_oe))
        mism = jnp.where(m_x > NEG, m_x + 1, NEG)
        new_m = jnp.maximum(mism, jnp.maximum(new_i, new_d))
        # tie order mismatch > I > D, mirroring wfa_affine_tb_batch
        pay_m = jnp.where(
            mism == new_m, p_x,
            jnp.where(new_i == new_m, pay_i, pay_d))
        vld = diag_valid(s1)
        new_m = clamp(jnp.where(vld, new_m, NEG))
        new_i = clamp(jnp.where(vld, new_i, NEG))
        new_d = clamp(jnp.where(vld, new_d, NEG))
        h_base = new_m
        new_m = _table_extend(new_m, run, vld, n1w)
        pay_m = pay_update(h_base, new_m, pay_m)

        idx = s1 % hist
        M = M.at[idx].set(new_m)
        I = I.at[idx].set(new_i)
        D = D.at[idx].set(new_d)
        PM = PM.at[idx].set(pay_m)
        PI = PI.at[idx].set(pay_i)
        PD = PD.at[idx].set(pay_d)
        newly = (result < 0) & done(new_m)
        pay_sel = jnp.max(jnp.where(tgt_mask, pay_m, -1), axis=1)
        out_pay = jnp.where(newly, pay_sel, out_pay)
        result = jnp.where(newly, s1, result)
        return s1, M, I, D, PM, PI, PD, result, out_pay

    init_done = done(m0)
    init_result = jnp.where(init_done, 0, -1)
    init_pay = jnp.where(init_done,
                         jnp.max(jnp.where(tgt_mask, p0, -1), axis=1), -1)
    state = (jnp.int32(0), M, I, D, PM, PI, PD, init_result, init_pay)
    out = jax.lax.while_loop(cond, body, state)
    result, out_pay = out[-2], out[-1]
    return (jnp.where(result < 0, smax + 1, result),
            jnp.where(result < 0, -1, out_pay))


@functools.partial(jax.jit,
                   static_argnames=("n1", "n2", "smax", "x", "o1", "e1",
                                    "o2", "e2", "wildcards", "kband"))
def wfa_affine2p_batch(refs, reads, ref_lens, read_lens, *, n1: int, n2: int,
                       smax: int, x: int = 4, o1: int = 6, e1: int = 2,
                       o2: int = 24, e2: int = 1, wildcards: bool = False,
                       kband: Optional[int] = None):
    """Dual-affine ("convex" piecewise) WFA: gap cost is the minimum of two
    affine classes (o1 + k*e1, o2 + k*e2) - WFA2-lib's affine2p model
    (SURVEY 2.9), the practical convex-gap approximation. Returns the
    minimal penalty [B] i32 (smax + 1 censored). Diagonals clamped to
    the exact band (see wfa_affine_batch / exact_kband); kband opts into
    the narrower heuristic band."""
    B = refs.shape[0]
    Kmax = min(n1 + n2, smax, exact_kband(smax, ((o1, e1), (o2, e2))))
    if kband is not None:
        Kmax = min(Kmax, kband)
    K = 2 * Kmax + 1
    ks = jnp.arange(K, dtype=jnp.int32) - Kmax
    hist = max(x, o1 + e1, e1, o2 + e2, e2) + 1

    refs_i = refs.astype(jnp.int32)
    reads_i = reads.astype(jnp.int32)
    l1 = ref_lens[:, None].astype(jnp.int32)
    l2 = read_lens[:, None].astype(jnp.int32)
    k_target = (l1 - l2)[:, 0]
    target_ok = jnp.abs(k_target) <= Kmax
    k_target = jnp.clip(k_target, -Kmax, Kmax)

    def clamp(offs):
        v = offs - ks[None, :]
        return jnp.where((offs <= l1) & (v <= l2) & (v >= 0) &
                         (ks[None, :] >= -l2) & (ks[None, :] <= l1),
                         offs, NEG)

    def diag_valid(s):
        return (jnp.abs(ks)[None, :] <= s) & \
            (ks[None, :] >= -l2) & (ks[None, :] <= l1)

    neg_wf = jnp.full((B, K), NEG, jnp.int32)
    n1w = refs_i.shape[1]
    run = _run_table(refs_i, reads_i, ks, l1, l2, wildcards=wildcards)
    m0 = jnp.where((ks == 0)[None, :] & jnp.ones((B, 1), bool), 0, NEG)
    m0 = _table_extend(m0, run, diag_valid(0), n1w)

    bufs = {name: jnp.full((hist, B, K), NEG, jnp.int32)
            for name in ("M", "I1", "D1", "I2", "D2")}
    bufs["M"] = bufs["M"].at[0].set(m0)

    def get(buf, s, back):
        ok = s - back >= 0
        return jnp.where(ok, buf[(s - back) % hist], neg_wf)

    tgt_mask = ks[None, :] == k_target[:, None]

    def done(m):
        # fixed one-hot mask + max instead of a per-step gather (see
        # _table_extend)
        tgt = jnp.max(jnp.where(tgt_mask, m, NEG), axis=1)
        return target_ok & (tgt >= l1[:, 0])

    def cond(state):
        s, M, I1, D1, I2, D2, result = state
        return (s < smax) & jnp.logical_not(jnp.all(result >= 0))

    def body(state):
        s, M, I1, D1, I2, D2, result = state
        s1 = s + 1

        def sr(w):
            return jnp.pad(w[:, :-1], ((0, 0), (1, 0)), constant_values=NEG)

        def sl(w):
            return jnp.pad(w[:, 1:], ((0, 0), (0, 1)), constant_values=NEG)

        vld = diag_valid(s1)
        new = {}
        for suffix, o, e in (("1", o1, e1), ("2", o2, e2)):
            m_oe = get(M, s1, o + e)
            i_e = get(I1 if suffix == "1" else I2, s1, e)
            d_e = get(D1 if suffix == "1" else D2, s1, e)
            nd = jnp.maximum(sr(m_oe), sr(d_e))
            new["D" + suffix] = clamp(jnp.where(
                vld, jnp.where(nd > NEG, nd + 1, NEG), NEG))
            new["I" + suffix] = clamp(jnp.where(
                vld, jnp.maximum(sl(m_oe), sl(i_e)), NEG))

        m_x = get(M, s1, x)
        mism = jnp.where(m_x > NEG, m_x + 1, NEG)
        nm = jnp.maximum(
            mism, jnp.maximum(jnp.maximum(new["I1"], new["D1"]),
                              jnp.maximum(new["I2"], new["D2"])))
        nm = clamp(jnp.where(vld, nm, NEG))
        nm = _table_extend(nm, run, vld, n1w)

        idx = s1 % hist
        M = M.at[idx].set(nm)
        I1 = I1.at[idx].set(new["I1"])
        D1 = D1.at[idx].set(new["D1"])
        I2 = I2.at[idx].set(new["I2"])
        D2 = D2.at[idx].set(new["D2"])
        result = jnp.where((result < 0) & done(nm), s1, result)
        return s1, M, I1, D1, I2, D2, result

    init_result = jnp.where(done(m0), 0, -1)
    state = (jnp.int32(0), bufs["M"], bufs["I1"], bufs["D1"], bufs["I2"],
             bufs["D2"], init_result)
    s, M, I1, D1, I2, D2, result = jax.lax.while_loop(cond, body, state)
    return jnp.where(result < 0, smax + 1, result)


@functools.partial(jax.jit,
                   static_argnames=("n1", "n2", "smax", "x", "o", "e",
                                    "wildcards", "kband", "adaptive"))
def wfa_affine_tb_batch(refs, reads, ref_lens, read_lens, *, n1: int,
                        n2: int, smax: int, x: int = 4, o: int = 6,
                        e: int = 2, wildcards: bool = False,
                        kband: Optional[int] = None,
                        adaptive: Optional[int] = None):
    """Gap-affine WFA with traceback: alongside the penalty, records a
    packed op-choice byte per (score step, lane, diagonal) — the batched
    answer to WFA2-lib's pcigar/backtrace blocks (wavefront_backtrace.o,
    wavefront_pcigar.o, SURVEY 2.9). The op store is [smax+1, B, K] u8
    (bits 0-1: M source 1=mismatch/2=I/3=D; bit 2: I came from extend;
    bit 3: D came from extend), K = 2*smax+1 diagonals — a 5%-divergent
    256x512bp batch stores ~13MB, transferred once; the host walks the op
    skeleton and REPLAYS greedy extension to rebuild full CIGARs exactly
    (extension is deterministic), so offsets never need to be stored.

    wildcards=True makes capture wildcards match-anything during
    extension: either byte < 58 (digit zones) or 'N'
    (scoring_functions.rs:100-102's special-character rule, as a 0-cost
    match approximation).

    Returns (penalty [B] i32 (smax+1 censored), ops [smax+1, B, K] u8).
    """
    B = refs.shape[0]
    Kmax = min(n1 + n2, smax, exact_kband(smax, ((o, e),)))
    if kband is not None:
        Kmax = min(Kmax, kband)
    K = 2 * Kmax + 1
    ks = jnp.arange(K, dtype=jnp.int32) - Kmax
    hist = max(x, o + e, e) + 1

    refs_i = refs.astype(jnp.int32)
    reads_i = reads.astype(jnp.int32)
    l1 = ref_lens[:, None].astype(jnp.int32)
    l2 = read_lens[:, None].astype(jnp.int32)
    k_target = (l1 - l2)[:, 0]
    target_ok = jnp.abs(k_target) <= Kmax
    k_target_c = jnp.clip(k_target, -Kmax, Kmax)

    n1w = refs_i.shape[1]
    run = _run_table(refs_i, reads_i, ks, l1, l2, wildcards=wildcards)

    def _extend_w(offsets, valid):
        return _table_extend(offsets, run, valid, n1w)

    def clamp(offs):
        v = offs - ks[None, :]
        return jnp.where((offs <= l1) & (v <= l2) & (v >= 0) &
                         (ks[None, :] >= -l2) & (ks[None, :] <= l1),
                         offs, NEG)

    def diag_valid(s):
        return (jnp.abs(ks)[None, :] <= s) & \
            (ks[None, :] >= -l2) & (ks[None, :] <= l1)

    neg_wf = jnp.full((B, K), NEG, jnp.int32)
    m0 = jnp.where((ks == 0)[None, :] & jnp.ones((B, 1), bool), 0, NEG)
    m0 = _extend_w(m0, diag_valid(0))

    M = jnp.full((hist, B, K), NEG, jnp.int32).at[0].set(m0)
    I = jnp.full((hist, B, K), NEG, jnp.int32)
    D = jnp.full((hist, B, K), NEG, jnp.int32)
    ops = jnp.zeros((smax + 1, B, K), jnp.uint8)

    def get(buf, s, back):
        idx = (s - back) % hist
        ok = s - back >= 0
        return jnp.where(ok, buf[idx], neg_wf)

    tgt_mask = ks[None, :] == k_target_c[:, None]

    def done(m):
        tgt = jnp.max(jnp.where(tgt_mask, m, NEG), axis=1)
        return target_ok & (tgt >= l1[:, 0])

    def cond(state):
        s, M, I, D, ops, result = state
        return (s < smax) & jnp.logical_not(jnp.all(result >= 0))

    def body(state):
        s, M, I, D, ops, result = state
        s1 = s + 1

        def sr(w):  # deletion direction: W[k-1], h+1
            return jnp.pad(w[:, :-1], ((0, 0), (1, 0)), constant_values=NEG)

        def sl(w):  # insertion direction: W[k+1], h unchanged
            return jnp.pad(w[:, 1:], ((0, 0), (0, 1)), constant_values=NEG)

        m_oe = get(M, s1, o + e)
        i_e = get(I, s1, e)
        d_e = get(D, s1, e)
        m_x = get(M, s1, x)

        d_open = sr(m_oe)
        d_ext = sr(d_e)
        new_d = jnp.maximum(d_open, d_ext)
        d_from_ext = d_ext > d_open          # tie -> open (fresh gap)
        new_d = jnp.where(new_d > NEG, new_d + 1, NEG)
        i_open = sl(m_oe)
        i_ext = sl(i_e)
        new_i = jnp.maximum(i_open, i_ext)
        i_from_ext = i_ext > i_open
        mism = jnp.where(m_x > NEG, m_x + 1, NEG)
        new_m = jnp.maximum(mism, jnp.maximum(new_i, new_d))
        # tie order mismatch > I > D (any choice yields an optimal path)
        m_src = jnp.where(
            new_m <= NEG, 0,
            jnp.where(mism == new_m, 1, jnp.where(new_i == new_m, 2, 3)))
        vld = diag_valid(s1)
        new_m = clamp(jnp.where(vld, new_m, NEG))
        new_i = clamp(jnp.where(vld, new_i, NEG))
        new_d = clamp(jnp.where(vld, new_d, NEG))
        new_m = _extend_w(new_m, vld)

        if adaptive is not None:
            # wf-adaptive dynamic trim (wavefront_heuristic.o's
            # wfadaptive): poison diagonals whose M antidiagonal progress
            # (h + v = 2h - k) lags the wavefront's best by more than the
            # margin. HEURISTIC — a trimmed diagonal might have carried
            # the optimal path; the engine keeps it opt-in and retries
            # censored pairs untrimmed (align_pairs escalation).
            prog = 2 * new_m - ks[None, :]
            has_m = new_m > NEG
            best = jnp.max(jnp.where(has_m, prog, NEG), axis=1,
                           keepdims=True)
            kill = has_m & (prog < best - adaptive)
            new_m = jnp.where(kill, NEG, new_m)
            new_i = jnp.where(kill, NEG, new_i)
            new_d = jnp.where(kill, NEG, new_d)

        op_byte = (m_src.astype(jnp.uint8)
                   | (i_from_ext.astype(jnp.uint8) << 2)
                   | (d_from_ext.astype(jnp.uint8) << 3))
        ops = ops.at[s1].set(op_byte)

        idx = s1 % hist
        M = M.at[idx].set(new_m)
        I = I.at[idx].set(new_i)
        D = D.at[idx].set(new_d)
        result = jnp.where((result < 0) & done(new_m), s1, result)
        return s1, M, I, D, ops, result

    init_result = jnp.where(done(m0), 0, -1)
    s, M, I, D, ops, result = jax.lax.while_loop(
        cond, body, (jnp.int32(0), M, I, D, ops, init_result))
    return jnp.where(result < 0, smax + 1, result), ops


@functools.partial(jax.jit,
                   static_argnames=("n1", "n2", "smax", "x", "o1", "e1",
                                    "o2", "e2", "wildcards", "kband",
                                    "adaptive"))
def wfa_affine2p_tb_batch(refs, reads, ref_lens, read_lens, *, n1: int,
                          n2: int, smax: int, x: int = 4, o1: int = 6,
                          e1: int = 2, o2: int = 24, e2: int = 1,
                          wildcards: bool = False,
                          kband: Optional[int] = None,
                          adaptive: Optional[int] = None):
    """Dual-affine ("convex") WFA with traceback: the affine op-byte scheme
    of wfa_affine_tb_batch extended to WFA2-lib's affine2p model
    (wavefront_compute_affine2p.o, SURVEY 2.9) — gap cost is
    min(o1 + n*e1, o2 + n*e2), approximating a convex gap penalty with two
    affine classes.

    Op byte per (score step, lane, diagonal):
      bits 0-2: M source (0 = none, 1 = mismatch, 2 = I1, 3 = D1,
                4 = I2, 5 = D2)
      bit 3: I1 from extend   bit 4: D1 from extend
      bit 5: I2 from extend   bit 6: D2 from extend
    The host backtrace (wfa_backtrace_ops_2p) walks 5 states and replays
    greedy extension exactly as the affine path does.

    Returns (penalty [B] i32 (smax+1 censored), ops [smax+1, B, K] u8)."""
    B = refs.shape[0]
    Kmax = min(n1 + n2, smax, exact_kband(smax, ((o1, e1), (o2, e2))))
    if kband is not None:
        Kmax = min(Kmax, kband)
    K = 2 * Kmax + 1
    ks = jnp.arange(K, dtype=jnp.int32) - Kmax
    hist = max(x, o1 + e1, e1, o2 + e2, e2) + 1

    refs_i = refs.astype(jnp.int32)
    reads_i = reads.astype(jnp.int32)
    l1 = ref_lens[:, None].astype(jnp.int32)
    l2 = read_lens[:, None].astype(jnp.int32)
    k_target = (l1 - l2)[:, 0]
    target_ok = jnp.abs(k_target) <= Kmax
    k_target_c = jnp.clip(k_target, -Kmax, Kmax)

    n1w = refs_i.shape[1]
    run = _run_table(refs_i, reads_i, ks, l1, l2, wildcards=wildcards)

    def clamp(offs):
        v = offs - ks[None, :]
        return jnp.where((offs <= l1) & (v <= l2) & (v >= 0) &
                         (ks[None, :] >= -l2) & (ks[None, :] <= l1),
                         offs, NEG)

    def diag_valid(s):
        return (jnp.abs(ks)[None, :] <= s) & \
            (ks[None, :] >= -l2) & (ks[None, :] <= l1)

    neg_wf = jnp.full((B, K), NEG, jnp.int32)
    m0 = jnp.where((ks == 0)[None, :] & jnp.ones((B, 1), bool), 0, NEG)
    m0 = _table_extend(m0, run, diag_valid(0), n1w)

    M = jnp.full((hist, B, K), NEG, jnp.int32).at[0].set(m0)
    gap = {name: jnp.full((hist, B, K), NEG, jnp.int32)
           for name in ("I1", "D1", "I2", "D2")}
    ops = jnp.zeros((smax + 1, B, K), jnp.uint8)

    def get(buf, s, back):
        idx = (s - back) % hist
        ok = s - back >= 0
        return jnp.where(ok, buf[idx], neg_wf)

    tgt_mask = ks[None, :] == k_target_c[:, None]

    def done(m):
        tgt = jnp.max(jnp.where(tgt_mask, m, NEG), axis=1)
        return target_ok & (tgt >= l1[:, 0])

    def cond(state):
        s, M, I1, D1, I2, D2, ops, result = state
        return (s < smax) & jnp.logical_not(jnp.all(result >= 0))

    def body(state):
        s, M, I1, D1, I2, D2, ops, result = state
        s1 = s + 1

        def sr(w):  # deletion direction: W[k-1], h+1
            return jnp.pad(w[:, :-1], ((0, 0), (1, 0)), constant_values=NEG)

        def sl(w):  # insertion direction: W[k+1], h unchanged
            return jnp.pad(w[:, 1:], ((0, 0), (0, 1)), constant_values=NEG)

        vld = diag_valid(s1)
        new = {}
        ext = {}
        for suffix, gbuf_i, gbuf_d, o, e in (("1", I1, D1, o1, e1),
                                             ("2", I2, D2, o2, e2)):
            m_oe = get(M, s1, o + e)
            i_e = get(gbuf_i, s1, e)
            d_e = get(gbuf_d, s1, e)
            d_open = sr(m_oe)
            d_ext = sr(d_e)
            nd = jnp.maximum(d_open, d_ext)
            ext["D" + suffix] = d_ext > d_open      # tie -> open
            new["D" + suffix] = clamp(jnp.where(
                vld, jnp.where(nd > NEG, nd + 1, NEG), NEG))
            i_open = sl(m_oe)
            i_ext = sl(i_e)
            ext["I" + suffix] = i_ext > i_open
            new["I" + suffix] = clamp(jnp.where(
                vld, jnp.maximum(i_open, i_ext), NEG))

        m_x = get(M, s1, x)
        mism = jnp.where(m_x > NEG, m_x + 1, NEG)
        nm = jnp.maximum(
            mism, jnp.maximum(jnp.maximum(new["I1"], new["D1"]),
                              jnp.maximum(new["I2"], new["D2"])))
        # tie order mismatch > I1 > D1 > I2 > D2 (any choice is optimal)
        m_src = jnp.where(
            nm <= NEG, 0,
            jnp.where(mism == nm, 1,
                      jnp.where(new["I1"] == nm, 2,
                                jnp.where(new["D1"] == nm, 3,
                                          jnp.where(new["I2"] == nm, 4,
                                                    5)))))
        nm = clamp(jnp.where(vld, nm, NEG))
        nm = _table_extend(nm, run, vld, n1w)

        if adaptive is not None:
            # wf-adaptive trim — see wfa_affine_tb_batch; applied to all
            # five wavefronts from the M wavefront's progress
            prog = 2 * nm - ks[None, :]
            has_m = nm > NEG
            best = jnp.max(jnp.where(has_m, prog, NEG), axis=1,
                           keepdims=True)
            kill = has_m & (prog < best - adaptive)
            nm = jnp.where(kill, NEG, nm)
            for name in ("I1", "D1", "I2", "D2"):
                new[name] = jnp.where(kill, NEG, new[name])

        op_byte = (m_src.astype(jnp.uint8)
                   | (ext["I1"].astype(jnp.uint8) << 3)
                   | (ext["D1"].astype(jnp.uint8) << 4)
                   | (ext["I2"].astype(jnp.uint8) << 5)
                   | (ext["D2"].astype(jnp.uint8) << 6))
        ops = ops.at[s1].set(op_byte)

        idx = s1 % hist
        M = M.at[idx].set(nm)
        I1 = I1.at[idx].set(new["I1"])
        D1 = D1.at[idx].set(new["D1"])
        I2 = I2.at[idx].set(new["I2"])
        D2 = D2.at[idx].set(new["D2"])
        result = jnp.where((result < 0) & done(nm), s1, result)
        return s1, M, I1, D1, I2, D2, ops, result

    init_result = jnp.where(done(m0), 0, -1)
    state = (jnp.int32(0), M, gap["I1"], gap["D1"], gap["I2"], gap["D2"],
             ops, init_result)
    s, M, I1, D1, I2, D2, ops, result = jax.lax.while_loop(cond, body, state)
    return jnp.where(result < 0, smax + 1, result), ops


def wfa_backtrace_ops_2p(ops: np.ndarray, scores: np.ndarray,
                         k_targets: np.ndarray, *, x: int, o1: int,
                         e1: int, o2: int, e2: int) -> list:
    """Host lockstep backtrace for the dual-affine op store
    (wfa_affine2p_tb_batch). Walks 5 states (M, I1, D1, I2, D2); gap
    class only changes the score decrement — the emitted skeleton ops
    stay {'X','I','i','D','d'} so wfa_replay_cigar works unchanged.
    Returns per-lane forward-order op lists (None for censored lanes)."""
    S1, B, K = ops.shape
    smax = (K - 1) // 2
    alive = (scores >= 0) & (scores < S1)
    s = np.where(alive, scores, 0).astype(np.int64)
    k = np.where(alive, k_targets, 0).astype(np.int64)
    state = np.zeros(B, dtype=np.int8)  # 0=M 1=I1 2=D1 3=I2 4=D2
    done = ~alive
    rev_ops: list = [[] for _ in range(B)]
    # (state id, op char, diag step, ext-bit shift, o, e)
    GAPS = ((1, "I", +1, 3, o1, e1), (2, "D", -1, 4, o1, e1),
            (3, "I", +1, 5, o2, e2), (4, "D", -1, 6, o2, e2))
    guard = 0
    while not done.all():
        guard += 1
        if guard > 4 * S1 + 8:
            raise RuntimeError("wfa affine2p backtrace failed to converge")
        byte = ops[s, np.arange(B), k + smax]
        m_src = byte & 7

        in_m = (state == 0) & ~done
        finish = in_m & (s == 0)
        done |= finish
        act_m = in_m & ~finish
        mm = act_m & (m_src == 1)
        for idx in np.nonzero(mm)[0]:
            rev_ops[idx].append("X")
        s = np.where(mm, s - x, s)
        for st in (2, 3, 4, 5):
            state = np.where(act_m & (m_src == st), st - 1, state)

        # lanes that just switched out of M wait for the next pass (the
        # byte re-read at the same (s, k) is correct), mirroring the
        # affine backtrace
        claimed = in_m
        for st, opch, dk, shift, o, e in GAPS:
            in_g = (state == st) & ~done & ~claimed
            claimed = claimed | in_g
            if not in_g.any():
                continue
            g_ext = (byte >> shift) & 1
            for idx in np.nonzero(in_g)[0]:
                rev_ops[idx].append(opch.lower() if g_ext[idx] else opch)
            s = np.where(in_g, s - np.where(g_ext == 1, e, o + e), s)
            k = np.where(in_g, k + dk, k)
            state = np.where(in_g & (g_ext == 0), 0, state)
    return [list(reversed(r)) if a else None
            for r, a in zip(rev_ops, alive)]


def wfa_backtrace_ops(ops: np.ndarray, scores: np.ndarray,
                      k_targets: np.ndarray, *, x: int, o: int,
                      e: int) -> list:
    """Host lockstep backtrace over the packed op store: walk every lane's
    op skeleton (non-match ops only; matches are re-derived by replay).
    ops is [S+1, B, K] u8 from wfa_affine_tb_batch, scores the returned
    penalties, k_targets = l1 - l2. Returns per-lane lists of ops in
    FORWARD order from {'X','I','D'} (None for censored lanes)."""
    S1, B, K = ops.shape
    smax = (K - 1) // 2
    alive = (scores >= 0) & (scores < S1)  # censored lanes excluded
    s = np.where(alive, scores, 0).astype(np.int64)
    k = np.where(alive, k_targets, 0).astype(np.int64)
    state = np.zeros(B, dtype=np.int8)  # 0=M 1=I 2=D
    done = ~alive
    rev_ops: list = [[] for _ in range(B)]
    guard = 0
    while not done.all():
        guard += 1
        if guard > 4 * S1 + 8:
            raise RuntimeError("wfa backtrace failed to converge")
        byte = ops[s, np.arange(B), k + smax]
        m_src = byte & 3
        i_ext = (byte >> 2) & 1
        d_ext = (byte >> 3) & 1

        in_m = (state == 0) & ~done
        finish = in_m & (s == 0)
        done |= finish
        act_m = in_m & ~finish
        # M from mismatch
        mm = act_m & (m_src == 1)
        for idx in np.nonzero(mm)[0]:
            rev_ops[idx].append("X")
        s = np.where(mm, s - x, s)
        state = np.where(act_m & (m_src == 2), 1, state)
        state = np.where(act_m & (m_src == 3), 2, state)

        # lanes that JUST switched to I/D this iteration (in_m) wait for
        # the next pass: their byte was read at the same (s, k), and the
        # re-read is correct
        in_i = (state == 1) & ~done & ~in_m
        for idx in np.nonzero(in_i)[0]:
            # lowercase = gap-extend step, uppercase = gap OPEN (the first
            # op of the gap in forward order) — replay only runs greedy
            # match extension at M states, i.e. before X/I/D, never
            # before i/d
            rev_ops[idx].append("i" if i_ext[idx] else "I")
        i_to_m = in_i & (i_ext == 0)
        s = np.where(in_i, s - np.where(i_ext == 1, e, o + e), s)
        k = np.where(in_i, k + 1, k)
        state = np.where(i_to_m, 0, state)

        in_d = (state == 2) & ~done & ~in_m & ~in_i
        for idx in np.nonzero(in_d)[0]:
            rev_ops[idx].append("d" if d_ext[idx] else "D")
        d_to_m = in_d & (d_ext == 0)
        s = np.where(in_d, s - np.where(d_ext == 1, e, o + e), s)
        k = np.where(in_d, k - 1, k)
        state = np.where(d_to_m, 0, state)
    return [list(reversed(r)) if a else None
            for r, a in zip(rev_ops, alive)]


@functools.partial(jax.jit, static_argnames=("model", "x", "o1", "e1",
                                              "o2", "e2"))
def wfa_walk_device(ops, scores, k_targets, *, model: str, x: int,
                    o1: int, e1: int, o2: int = 0, e2: int = 0):
    """On-device WFA backtrace walk (decision-identical to the host
    walkers wfa_backtrace_ops / wfa_backtrace_ops_2p).

    The host walkers need the [S+1, B, K] op store pulled to the host —
    at SV ceilings that window transfer dominated the whole convex path
    (BENCH_SECONDARY convex_phase_seconds: ~75% of engine wall). This
    walk reads the store ON DEVICE with one reverse lax.scan over the
    score-row axis (each lane's row pointer strictly decreases, so every
    row is visited at most once — the same trick as the DP engine's
    packed-word walk, batch.py:_finish_from_packed_traceback) and one-hot
    diagonal selects instead of per-step gathers, then ships only
    the O(S) per-lane op skeleton.

    A lane emits at most ONE op per row: an M->gap state switch re-reads
    the SAME (s, k) byte (see the host walkers' 'wait for the next pass'
    comment), so the switch and its first gap step fuse into one scan
    step here.

    Returns (ops_fwd [B, S+1] u8 — op bytes in FORWARD path order,
    0-padded; 'X'=mismatch, 'I'/'D'=gap open, 'i'/'d'=gap extend —
    and fin [B] i32, -1 where the walk converged; censored lanes
    (score > smax) return fin = -2)."""
    S1, B, K = ops.shape
    smax_k = (K - 1) // 2
    alive = (scores >= 0) & (scores < S1)
    s = jnp.where(alive, scores, -2).astype(jnp.int32)
    k = jnp.clip(jnp.where(alive, k_targets, 0),
                 -smax_k, smax_k).astype(jnp.int32)
    state = jnp.zeros(B, jnp.int32)
    iota_k = jnp.arange(K, dtype=jnp.int32)[None, :]
    m_mask = 7 if model == "affine2p" else 3
    # per gap-state constants: (diag step, ext-bit shift, open cost,
    # extend cost); state ids 1..4 = I1, D1, I2, D2 (affine: 1..2 = I, D)
    if model == "affine2p":
        gaps = ((1, +1, 3, o1 + e1, e1), (2, -1, 4, o1 + e1, e1),
                (3, +1, 5, o2 + e2, e2), (4, -1, 6, o2 + e2, e2))
    else:
        gaps = ((1, +1, 2, o1 + e1, e1), (2, -1, 3, o1 + e1, e1))

    def step(carry, inp):
        s, k, state = carry
        row, row_ops = inp
        byte = jnp.sum(jnp.where(iota_k == (k + smax_k)[:, None],
                                 row_ops.astype(jnp.int32), 0), axis=1)
        # M action at this row
        in_m = (s == row) & (state == 0)
        finish = in_m & (row == 0)
        m_src = byte & m_mask
        mm = in_m & ~finish & (m_src == 1)
        op = jnp.where(mm, jnp.int32(88), 0)            # 'X'
        s = jnp.where(mm, s - x, s)
        s = jnp.where(finish, -1, s)
        sw = in_m & ~finish & (m_src >= 2)
        state = jnp.where(sw, m_src - 1, state)
        # gap action: lanes in a gap state whose row pointer is still
        # here — both just-switched lanes (same byte, per the host
        # walkers) and lanes that arrived in an open gap
        in_g = (s == row) & (state > 0)
        for st, dk, shift, oe_cost, e_cost in gaps:
            g = in_g & (state == st)
            ext = (byte >> shift) & 1
            upper = jnp.int32(73 if dk > 0 else 68)     # 'I' / 'D'
            lower = jnp.int32(105 if dk > 0 else 100)   # 'i' / 'd'
            op = jnp.where(g, jnp.where(ext == 1, lower, upper), op)
            s = jnp.where(g, s - jnp.where(ext == 1, e_cost, oe_cost), s)
            k = jnp.where(g, k + dk, k)
            state = jnp.where(g & (ext == 0), 0, state)
        return (s, k, state), op.astype(jnp.uint8)

    rows = jnp.arange(S1, dtype=jnp.int32)
    (s, _k, _st), ys = jax.lax.scan(step, (s, k, state), (rows, ops),
                                    reverse=True)
    # ys[row] = op emitted at that row; forward path order = ascending
    # rows. Left-compact the non-zero ops per lane (stable argsort).
    ops_rows = jnp.transpose(ys, (1, 0))                # [B, S1]
    order = jnp.argsort((ops_rows == 0).astype(jnp.int32), axis=1,
                        stable=True)
    ops_fwd = jnp.take_along_axis(ops_rows, order, axis=1)
    return ops_fwd, s


def _wild(c: int) -> bool:
    return c < 58 or c == 78


def wfa_replay_cigar(a: bytes, b: bytes, skeleton,
                     wildcards: bool = False):
    """Rebuild the full CIGAR from an op skeleton by replaying greedy
    match extension (deterministic, identical to the kernel's _extend).
    Returns [(count, op)] with 'M' covering matches+mismatches.

    Each extension is one numpy slice comparison instead of a per-byte
    python loop (extensions cover nearly the whole read on low-divergence
    HiFi input, and this replay was the HiFi align bottleneck)."""
    import numpy as np

    h = v = 0
    l1, l2 = len(a), len(b)
    a_arr = np.frombuffer(a, dtype=np.uint8)
    b_arr = np.frombuffer(b, dtype=np.uint8)
    stop_a = (a_arr >= 58) & (a_arr != 78) if wildcards else None
    stop_b = (b_arr >= 58) & (b_arr != 78) if wildcards else None

    def run_len(h, v):
        n = min(l1 - h, l2 - v)
        if n <= 0:
            return 0
        stop = a_arr[h:h + n] != b_arr[v:v + n]
        if wildcards:
            stop &= stop_a[h:h + n] & stop_b[v:v + n]
        i = int(stop.argmax())
        return i if stop[i] else n

    raw: list = []

    def emit(op, n=1):
        if n <= 0:
            return
        if raw and raw[-1][1] == op:
            raw[-1] = (raw[-1][0] + n, op)
        else:
            raw.append((n, op))

    for op in skeleton:
        if op in ("X", "I", "D"):
            # M state: greedy extension happened before this op in the
            # forward pass (lowercase gap-extends have no matches before
            # them — they continue an open gap)
            run = run_len(h, v)
            h += run
            v += run
            emit("M", run)
        if op == "X":
            emit("M", 1)
            h += 1
            v += 1
        elif op in ("I", "i"):
            emit("I", 1)
            v += 1
        elif op in ("D", "d"):
            emit("D", 1)
            h += 1
    run = run_len(h, v)
    h += run
    v += run
    emit("M", run)
    if h != l1 or v != l2:
        raise ValueError(
            f"wfa replay did not consume both sequences: ({h},{v}) vs "
            f"({l1},{l2})")
    return raw


def cigar_penalty(cigar, a: bytes, b: bytes, *, x: int, o: int, e: int,
                  wildcards: bool = False) -> int:
    """Affine penalty of a CIGAR over a pair (match 0, mismatch x, gap
    o + n*e) — the checkable invariant for traceback tests."""
    h = v = 0
    p = 0
    for n, op in cigar:
        if op == "M":
            for _ in range(n):
                if not (a[h] == b[v] or
                        (wildcards and (_wild(a[h]) or _wild(b[v])))):
                    p += x
                h += 1
                v += 1
        elif op == "I":
            p += o + n * e
            v += n
        elif op == "D":
            p += o + n * e
            h += n
    return p


def wfa_affine_align_pairs(pairs_a, pairs_b, *, x: int = 4, o: int = 6,
                           e: int = 2, smax=None, wildcards: bool = False,
                           pad_to: int = 64):
    """Host wrapper: batched gap-affine WFA WITH traceback. Returns a list
    of (penalty, cigar) per pair; cigar is None when the pair was censored
    at smax (penalty = smax + 1)."""
    if not pairs_a:
        return []
    L = max(pad_to, max(max(len(a) for a in pairs_a),
                        max(len(b) for b in pairs_b)))
    P = len(pairs_a)
    Ppad = 32
    while Ppad < P:
        Ppad *= 2
    a = np.zeros((Ppad, L), dtype=np.uint8)
    b = np.zeros((Ppad, L), dtype=np.uint8)
    la = np.zeros(Ppad, dtype=np.int32)
    lb = np.zeros(Ppad, dtype=np.int32)
    for i, (s, t) in enumerate(zip(pairs_a, pairs_b)):
        a[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
        b[i, :len(t)] = np.frombuffer(t, dtype=np.uint8)
        la[i], lb[i] = len(s), len(t)
    if smax is None:
        smax = x + o + e * L  # worst case bound: all-gap then mismatches
    scores, ops = wfa_affine_tb_batch(a, b, la, lb, n1=L, n2=L, smax=smax,
                                      x=x, o=o, e=e, wildcards=wildcards)
    scores = np.asarray(scores)[:P]
    ops = np.asarray(ops)[:, :P]
    skeletons = wfa_backtrace_ops(ops, scores, (la - lb)[:P],
                                  x=x, o=o, e=e)
    out = []
    for i in range(P):
        if skeletons[i] is None:
            out.append((int(scores[i]), None))
            continue
        cig = wfa_replay_cigar(pairs_a[i], pairs_b[i], skeletons[i],
                               wildcards=wildcards)
        out.append((int(scores[i]), cig))
    return out


def _mid_split_batch(pairs, *, x: int, o: int, e: int, wildcards: bool,
                     s0: Optional[int] = None):
    """Run wfa_affine_mid_batch over (a, b) byte pairs with the 2x
    score-ceiling escalation ladder (only censored pairs re-run).
    Returns [(penalty, h, v)] per pair; (smax+1, -1, -1) if censored at
    the hard bound (cannot happen below it: x + o + e*L covers any pair).
    """
    P = len(pairs)
    out = [None] * P
    pending = list(range(P))
    L = max(64, max(max(len(a), len(b)) for a, b in pairs))
    q = 128
    L = max(q, -(-L // q) * q)
    if L >= _MID_ENC // 2:
        raise ValueError(f"bialign split encoding caps lengths at "
                         f"{_MID_ENC // 2 - 1}; got {L}")
    hard = 2 * (o + e * L) + 1  # delete-all + insert-all upper bound
    if s0 is None:
        # lower-bound rung: the length gap alone costs o + e*d
        dmax = max(abs(len(a) - len(b)) for a, b in pairs)
        s0 = 64
        while s0 <= o + e * dmax:
            s0 *= 2
    smax = min(s0, hard)
    while pending:
        Ppad = 32
        while Ppad < len(pending):
            Ppad *= 2
        a = np.zeros((Ppad, L), dtype=np.uint8)
        b = np.zeros((Ppad, L), dtype=np.uint8)
        la = np.zeros(Ppad, dtype=np.int32)
        lb = np.zeros(Ppad, dtype=np.int32)
        for i, idx in enumerate(pending):
            s_a, s_b = pairs[idx]
            a[i, :len(s_a)] = np.frombuffer(s_a, dtype=np.uint8)
            b[i, :len(s_b)] = np.frombuffer(s_b, dtype=np.uint8)
            la[i], lb[i] = len(s_a), len(s_b)
        pen, pay = wfa_affine_mid_batch(a, b, la, lb, n1=L, n2=L,
                                        smax=smax, x=x, o=o, e=e,
                                        wildcards=wildcards)
        pen = np.asarray(pen)
        pay = np.asarray(pay)
        still = []
        for i, idx in enumerate(pending):
            if pen[i] <= smax and pay[i] >= 0:
                out[idx] = (int(pen[i]), int(pay[i]) // _MID_ENC,
                            int(pay[i]) % _MID_ENC)
            elif smax >= hard:
                out[idx] = (smax + 1, -1, -1)
            else:
                still.append(idx)
        pending = still
        smax = min(smax * 2, hard)
    return out


def wfa_bialign_affine_pairs(pairs_a, pairs_b, *, x: int = 4, o: int = 6,
                             e: int = 2, wildcards: bool = False,
                             leaf: int = 512, s0: Optional[int] = None):
    """O(s)-memory batched gap-affine alignment WITH traceback — the
    batched equivalent of WFA2-lib's bialign mode (wavefront_bialign.o, SURVEY
    2.9: bound traceback memory for long/divergent pairs by splitting at
    a breakpoint and recursing).

    Each level runs ONE batched midpoint sweep (wfa_affine_mid_batch,
    O(B*K) memory — no op store) over every segment still longer than
    `leaf`, splits each at its reported on-path M-state cell, and
    recurses; segments at or under `leaf` run the direct traceback
    kernel in one batch per level (wfa_affine_align_pairs). Segments
    whose split is degenerate (the optimal path crosses the middle
    anti-diagonal inside one gap run that starts at the segment edge)
    fall back to the direct kernel at their full length — correct, and
    rare outside all-gap corner cases.

    Returns [(penalty, cigar)] per pair; cigars merge adjacent runs, and
    penalty is the top-level kernel's optimum (tests assert
    cigar_penalty == penalty)."""
    n = len(pairs_a)
    results: list = [None] * n
    top_pen = [None] * n
    # segment worklist: (pair idx, order path, a, b, forced_leaf)
    segs = [(i, (), bytes(a), bytes(b), False)
            for i, (a, b) in enumerate(zip(pairs_a, pairs_b))]
    leaves: list = []
    while segs:
        split_jobs = []
        nxt: list = []
        for seg in segs:
            i, path, a, b, forced = seg
            if not a or not b:
                leaves.append(seg)
            elif forced or max(len(a), len(b)) <= leaf:
                leaves.append(seg)
            else:
                split_jobs.append(seg)
        if not split_jobs:
            break
        outs = _mid_split_batch([(s[2], s[3]) for s in split_jobs],
                                x=x, o=o, e=e, wildcards=wildcards, s0=s0)
        for (i, path, a, b, _f), (pen, h, v) in zip(split_jobs, outs):
            if not path and h >= 0:
                top_pen[i] = pen
            if h < 0:
                leaves.append((i, path, a, b, True))
            elif (h, v) in ((0, 0), (len(a), len(b))):
                # path crosses mid inside an edge gap: no shrink possible
                leaves.append((i, path, a, b, True))
            else:
                nxt.append((i, path + (0,), a[:h], b[:v], False))
                nxt.append((i, path + (1,), a[h:], b[v:], False))
        segs = nxt

    # resolve leaves: gap-only segments directly, the rest batched tb
    pieces: dict = {}
    tb_jobs = []
    for i, path, a, b, _f in leaves:
        if not a and not b:
            pieces[(i, path)] = []
        elif not a:
            pieces[(i, path)] = [(len(b), "I")]
        elif not b:
            pieces[(i, path)] = [(len(a), "D")]
        else:
            tb_jobs.append((i, path, a, b))
    # chunked leaf batches: the direct kernel's op store is O(smax*B*K);
    # 64 lanes per call keeps each batch a few hundred MB at leaf=512
    for lo in range(0, len(tb_jobs), 64):
        sl_jobs = tb_jobs[lo:lo + 64]
        outs = wfa_affine_align_pairs([j[2] for j in sl_jobs],
                                      [j[3] for j in sl_jobs],
                                      x=x, o=o, e=e, wildcards=wildcards)
        for (i, path, a, b), (pen, cig) in zip(sl_jobs, outs):
            if cig is None:  # unreachable: full-bound smax never censors
                raise RuntimeError("bialign leaf censored at full bound")
            pieces[(i, path)] = cig

    by_pair: dict = {}
    for (i, p), cig in pieces.items():
        by_pair.setdefault(i, []).append((p, cig))
    for i in range(n):
        merged: list = []
        for _p, cig in sorted(by_pair.get(i, [])):
            for run_ in cig:
                if merged and merged[-1][1] == run_[1]:
                    merged[-1] = (merged[-1][0] + run_[0], run_[1])
                else:
                    merged.append(run_)
        pen = top_pen[i]
        if pen is None:  # pair went straight to a leaf (short/empty)
            pen = cigar_penalty(merged, pairs_a[i], pairs_b[i],
                                x=x, o=o, e=e, wildcards=wildcards)
        results[i] = (pen, merged)
    return results


def affine_penalty_golden(a: bytes, b: bytes, *, x: int, o: int,
                          e: int, wildcards: bool = False) -> int:
    """O(nm) min-penalty gap-affine DP (numpy, host): the independent
    golden for the WFA kernels (match 0 / mismatch x / gap o + n*e,
    Gotoh three-plane)."""
    n1, n2 = len(a), len(b)
    INF = 1 << 29
    av = np.frombuffer(a, dtype=np.uint8).astype(np.int32)
    bv = np.frombuffer(b, dtype=np.uint8).astype(np.int32)
    sub = (av[:, None] != bv[None, :]).astype(np.int64) * x
    if wildcards:
        wild = ((av[:, None] < 58) | (av[:, None] == 78) |
                (bv[None, :] < 58) | (bv[None, :] == 78))
        sub = np.where(wild, 0, sub)
    M = np.full((n1 + 1, n2 + 1), INF, dtype=np.int64)
    I = np.full((n1 + 1, n2 + 1), INF, dtype=np.int64)
    D = np.full((n1 + 1, n2 + 1), INF, dtype=np.int64)
    M[0, 0] = 0
    for j in range(1, n2 + 1):
        I[0, j] = o + j * e
        M[0, j] = I[0, j]
    for i in range(1, n1 + 1):
        D[i, 0] = o + i * e
        M[i, 0] = D[i, 0]
    for i in range(1, n1 + 1):
        for j in range(1, n2 + 1):
            I[i, j] = min(M[i, j - 1] + o + e, I[i, j - 1] + e)
            D[i, j] = min(M[i - 1, j] + o + e, D[i - 1, j] + e)
            M[i, j] = min(M[i - 1, j - 1] + sub[i - 1, j - 1],
                          I[i, j], D[i, j])
    return int(M[n1, n2])


def cigar_penalty_2p(cigar, a: bytes, b: bytes, *, x: int, o1: int,
                     e1: int, o2: int, e2: int,
                     wildcards: bool = False) -> int:
    """Dual-affine penalty of a CIGAR (match 0, mismatch x, gap of length n
    costs min(o1 + n*e1, o2 + n*e2)) — the checkable invariant for the
    convex traceback tests."""
    h = v = 0
    p = 0
    for n, op in cigar:
        if op == "M":
            for _ in range(n):
                if not (a[h] == b[v] or
                        (wildcards and (_wild(a[h]) or _wild(b[v])))):
                    p += x
                h += 1
                v += 1
        elif op == "I":
            p += min(o1 + n * e1, o2 + n * e2)
            v += n
        elif op == "D":
            p += min(o1 + n * e1, o2 + n * e2)
            h += n
    return p


def affine2p_penalty_golden(a: bytes, b: bytes, *, x: int, o1: int,
                            e1: int, o2: int, e2: int,
                            wildcards: bool = False) -> int:
    """O(nm) min-penalty dual-affine DP (numpy, host): the independent
    golden for the affine2p WFA kernels — Gotoh with five planes
    (M, I1, D1, I2, D2), gap cost min over the two affine classes
    (WFA2-lib's affine2p model, SURVEY 2.9)."""
    n1, n2 = len(a), len(b)
    INF = 1 << 29
    av = np.frombuffer(a, dtype=np.uint8).astype(np.int32)
    bv = np.frombuffer(b, dtype=np.uint8).astype(np.int32)
    sub = (av[:, None] != bv[None, :]).astype(np.int64) * x
    if wildcards:
        wild = ((av[:, None] < 58) | (av[:, None] == 78) |
                (bv[None, :] < 58) | (bv[None, :] == 78))
        sub = np.where(wild, 0, sub)
    M = np.full((n1 + 1, n2 + 1), INF, dtype=np.int64)
    I1 = np.full((n1 + 1, n2 + 1), INF, dtype=np.int64)
    D1 = np.full((n1 + 1, n2 + 1), INF, dtype=np.int64)
    I2 = np.full((n1 + 1, n2 + 1), INF, dtype=np.int64)
    D2 = np.full((n1 + 1, n2 + 1), INF, dtype=np.int64)
    M[0, 0] = 0
    for j in range(1, n2 + 1):
        I1[0, j] = o1 + j * e1
        I2[0, j] = o2 + j * e2
        M[0, j] = min(I1[0, j], I2[0, j])
    for i in range(1, n1 + 1):
        D1[i, 0] = o1 + i * e1
        D2[i, 0] = o2 + i * e2
        M[i, 0] = min(D1[i, 0], D2[i, 0])
    for i in range(1, n1 + 1):
        for j in range(1, n2 + 1):
            I1[i, j] = min(M[i, j - 1] + o1 + e1, I1[i, j - 1] + e1)
            D1[i, j] = min(M[i - 1, j] + o1 + e1, D1[i - 1, j] + e1)
            I2[i, j] = min(M[i, j - 1] + o2 + e2, I2[i, j - 1] + e2)
            D2[i, j] = min(M[i - 1, j] + o2 + e2, D2[i - 1, j] + e2)
            M[i, j] = min(M[i - 1, j - 1] + sub[i - 1, j - 1],
                          I1[i, j], D1[i, j], I2[i, j], D2[i, j])
    return int(M[n1, n2])


def cigar_to_aligned(a: bytes, b: bytes, cigar) -> Tuple[bytes, bytes]:
    """Expand a [(count, op)] CIGAR over (a, b) into the gapped aligned
    pair (a_aligned, b_aligned); gaps are '-'."""
    out_a = bytearray()
    out_b = bytearray()
    h = v = 0
    for n, op in cigar:
        if op == "M":
            out_a += a[h:h + n]
            out_b += b[v:v + n]
            h += n
            v += n
        elif op == "I":
            out_a += b"-" * n
            out_b += b[v:v + n]
            v += n
        elif op == "D":
            out_a += a[h:h + n]
            out_b += b"-" * n
            h += n
    return bytes(out_a), bytes(out_b)


class WfaAligner:
    """Pipeline-facing batched WFA engine with traceback.

    Drop-in for BatchAligner.align_pairs: align_pairs(refs, reads) ->
    [(ref_aligned, read_aligned, cigar, score)]. This is the product
    wiring for WFA2-lib's engine role (SURVEY 2.9: the reference ships the
    library as its intended fast aligner but never calls it; here `clique
    align --engine wfa` and the HiFi mode run on it).

    Strategy: batch pairs by padded length, run the gap-affine traceback
    kernel with a small score ceiling, and ADAPTIVELY retry censored pairs
    at 2x the ceiling (WFA work grows O(s^2), so most low-divergence pairs
    finish at the first ceiling and only stragglers pay more - the batched
    analogue of wavefront_heuristic.o's score cutoffs, without dropping
    accuracy). Pairs still censored at smax > 2*L fall back to the exact
    3-plane DP (at that divergence the quadratic DP does less work than
    the wavefront would). Wildcard bytes (digits / N) extend as matches,
    mirroring the special-character scoring rule
    (scoring_functions.rs:100-102).

    Reported score is the NEGATED WFA penalty (max-is-better like the DP
    path; exact values differ from the DP scoring scheme by design).

    model="affine2p" switches to the dual-affine ("convex") penalty set
    (x, o, e, o2, e2): gap cost min(o + n*e, o2 + n*e2) — WFA2-lib's
    affine2p model (wavefront_compute_affine2p.o, SURVEY 2.9), exposed
    as `clique align --engine convex`. Long gaps (structural deletions,
    cassette drop-outs) then pay the cheap second slope instead of
    fragmenting into mismatch runs."""

    def __init__(self, x: int = 4, o: int = 6, e: int = 2,
                 batch_size: int = 512, length_quantum: int = 128,
                 wildcards: bool = True, s0: Optional[int] = None,
                 dp_fallback=None, model: str = "affine",
                 o2: int = 24, e2: int = 1, kband: Optional[int] = None,
                 adaptive: Optional[int] = None):
        if model not in ("affine", "affine2p"):
            raise ValueError(f"unknown WFA penalties model: {model}")
        self.model = model
        self.x, self.o, self.e = x, o, e
        self.o2, self.e2 = o2, e2
        self.batch_size = batch_size
        self.quantum = length_quantum
        self.wildcards = wildcards
        self.s0 = s0
        # optional heuristic diagonal band (wavefront_heuristic.o's band
        # reduction): first-round kernels clamp |k| <= kband; censored
        # pairs retry WITHOUT the band so accuracy is never lost, only a
        # straggler pays twice. None = exact band only (default).
        self.kband = kband
        # optional wf-adaptive dynamic trim margin
        # (wavefront_heuristic.o's wfadaptive): first-round kernels drop
        # diagonals whose antidiagonal progress lags the wavefront best
        # by more than this; censored pairs retry untrimmed. A finished
        # trimmed result is HEURISTIC (like WFA2's wf-adaptive) — the
        # trim can, in principle, cut the optimal path while a valid
        # suboptimal one still reaches the target; default off keeps the
        # engine exact. CLIQUE_WFA_ADAPTIVE sets a margin globally.
        if adaptive is None:
            env_a = os.environ.get("CLIQUE_WFA_ADAPTIVE")
            adaptive = int(env_a) if env_a else None
        self.adaptive = adaptive
        self.dp_fallback = dp_fallback  # BatchAligner or None
        self.pairs_aligned = 0
        self.cells_filled = 0           # DP-equivalent n*m cells
        self.device_seconds = 0.0
        self.post_seconds = 0.0
        self.fallbacks = 0
        # per-phase wall breakdown (VERDICT r3 item 6): dispatch = host
        # prep + kernel enqueue; score_sync = blocking score pulls;
        # window_pull = blocking backtrace-window pulls; host_walk =
        # backtrace + CIGAR replay on host. Sums to ~device_seconds.
        self.phase_seconds = {"dispatch": 0.0, "score_sync": 0.0,
                              "window_pull": 0.0, "host_walk": 0.0}

    def _kmax(self, L: int, smax: int, kband: Optional[int]) -> int:
        """The kernel's actual diagonal half-width for (L, smax): exact
        band intersected with the heuristic band (must mirror the
        kernels' Kmax computation for window slicing + memory sizing)."""
        if self.model == "affine2p":
            kb = exact_kband(smax, ((self.o, self.e), (self.o2, self.e2)))
        else:
            kb = exact_kband(smax, ((self.o, self.e),))
        kmax = min(2 * L, smax, kb)
        if kband is not None:
            kmax = min(kmax, kband)
        return kmax

    def _tb_kernel(self, a, b, la, lb, *, L, smax, kband=None,
                   adaptive=None):
        if self.model == "affine2p":
            return wfa_affine2p_tb_batch(
                a, b, la, lb, n1=L, n2=L, smax=smax, x=self.x, o1=self.o,
                e1=self.e, o2=self.o2, e2=self.e2,
                wildcards=self.wildcards, kband=kband, adaptive=adaptive)
        return wfa_affine_tb_batch(
            a, b, la, lb, n1=L, n2=L, smax=smax, x=self.x, o=self.o,
            e=self.e, wildcards=self.wildcards, kband=kband,
            adaptive=adaptive)

    def _backtrace(self, ops, scores, k_targets):
        if self.model == "affine2p":
            return wfa_backtrace_ops_2p(ops, scores, k_targets, x=self.x,
                                        o1=self.o, e1=self.e, o2=self.o2,
                                        e2=self.e2)
        return wfa_backtrace_ops(ops, scores, k_targets, x=self.x,
                                 o=self.o, e=self.e)

    def _walk_dispatch(self, ops_dev, scores_dev, la, lb):
        """Dispatch the on-device backtrace walk over a chunk's full op
        store (decision-identical to _backtrace; see wfa_walk_device)."""
        return wfa_walk_device(
            ops_dev, scores_dev, jnp.asarray(la - lb, jnp.int32),
            model=self.model, x=self.x, o1=self.o, e1=self.e,
            o2=self.o2, e2=self.e2)

    @staticmethod
    def _decode_walk(walk, n: int) -> list:
        """Pull a dispatched walk's (ops_fwd, fin) and decode the first n
        lanes' skeleton lists (None where censored)."""
        ops_np = np.asarray(walk[0])
        fin_np = np.asarray(walk[1])
        out = []
        for b in range(n):
            if fin_np[b] == -2:
                out.append(None)
                continue
            if fin_np[b] != -1:
                raise RuntimeError(
                    f"wfa device walk failed to converge (lane {b}, "
                    f"fin={fin_np[b]})")
            row = ops_np[b]
            out.append([chr(c) for c in row[row != 0]])
        return out

    def _bucket_len(self, n: int) -> int:
        q = self.quantum
        return max(q, -(-n // q) * q)

    def _ceil_b(self, n: int) -> int:
        b = 32
        while b < n:
            b *= 2
        return b

    def _budget(self) -> int:
        # chosen budgets (the wave loop holds <= 2x this live): affine2p
        # takes 2GB because its escalated rounds have wide K, so bigger
        # chunks mean fewer result pulls; the affine model keeps 512MB.
        # Neither is yet sized for the H100's 80GB (ROADMAP S8).
        default = (2 << 30) if self.model == "affine2p" else (512 << 20)
        return int(os.environ.get("CLIQUE_WFA_MEM_BUDGET", str(default)))

    def _chunk_bytes(self, B: int, L: int, smax: int,
                     kband: Optional[int] = None) -> int:
        """Estimated kernel device-memory footprint of one chunk: the
        [smax+1, B, K] op store plus the packed [B, K, W] bitmap/wordrun
        tables (8 bytes per 32 offsets) and the [B, K, H] bool eq
        intermediate the table build materializes. K follows the
        kernel's exact/heuristic band."""
        K = 2 * self._kmax(L, smax, kband) + 1
        W = (L + 33) // 32
        return B * K * ((smax + 1) + 8 * W + (L + 2))

    def _mem_cap(self, L: int, smax: int,
                 kband: Optional[int] = None) -> int:
        """Largest power-of-2 lane count whose chunk footprint fits the
        budget (_budget: CLIQUE_WFA_MEM_BUDGET, default 512MB affine /
        2GB affine2p) — long-read buckets
        run in smaller slices instead of OOMing. Floors at 32 lanes; a
        floor chunk can exceed the budget, which the wave loop in
        align_pairs accounts for by running it alone."""
        budget = self._budget()
        b = 32
        while self._chunk_bytes(b * 2, L, smax, kband) <= budget:
            b *= 2
        return b

    def align_pairs(self, refs, reads):
        """Pipelined engine loop: per retry round, EVERY chunk of EVERY
        length bucket dispatches its kernel before any result is pulled,
        then all score pulls overlap, then all backtrace-window slices
        dispatch and overlap, so no chunk waits on another's
        device->host sync."""
        import time

        results = [None] * len(refs)
        t0 = time.time()
        fallback: list = []
        bialign_pool: list = []  # affine pairs routed to the O(s)-memory
        #                          bialign engine (op store over budget)
        buckets: dict = {}
        for k in range(len(refs)):
            L = self._bucket_len(max(len(refs[k]), len(reads[k])))
            buckets.setdefault(L, []).append(k)
        work = []                # (L, smax, idxs, kband, adaptive)
        for L in sorted(buckets):
            if L + 1 >= (1 << 15):
                # ultra-long pairs: the op store at smax ~ L/4 would be
                # enormous; the anchored/banded exact DP handles these
                fallback.extend(buckets[L])
                continue
            if self.s0 is not None:
                idxs = sorted(buckets[L], key=lambda k:
                              abs(len(refs[k]) - len(reads[k])))
                work.append((L, self.s0, idxs, self.kband, self.adaptive))
                continue
            # Penalty-aware initial ceilings: a pair's length gap d
            # lower-bounds its penalty at min(o+e*d, o2+e2*d) (every net
            # indel pays at least the cheaper gap slope), so a
            # structural-variant lane whose bound exceeds the base
            # ceiling would CENSOR round 1 and rerun at an escalated
            # ceiling — pure waste. Start such lanes directly on the
            # smallest rung of the base*2^n ladder that covers bound +
            # base/4 slack (the slack absorbs substitutions). Grouping
            # by rung keeps chunk shapes uniform (each distinct
            # (L, smax) is a separate compile) and preserves the
            # tight-backtrace-window property: similar-penalty lanes
            # share chunks, so phase C windows stay sized by their own
            # round's max score, not the batch's worst SV lane.
            base = max(64, L // 4)
            rungs: dict = {}
            for k in buckets[L]:
                d = abs(len(refs[k]) - len(reads[k]))
                bound = 0 if d == 0 else min(
                    self.o + self.e * d, self.o2 + self.e2 * d) \
                    if self.model == "affine2p" else self.o + self.e * d
                s = base
                while s < bound + base // 4:
                    s *= 2
                rungs.setdefault(s, []).append(k)
            for s, idxs in sorted(rungs.items()):
                if self.model == "affine" and \
                        self._chunk_bytes(32, L, s, self.kband) > \
                        self._budget():
                    # even a floor chunk's op store blows the budget:
                    # these (long, high-penalty-bound) pairs go to the
                    # O(s)-memory bialign engine (wavefront_bialign.o)
                    bialign_pool.extend(idxs)
                    continue
                idxs.sort(key=lambda k: abs(len(refs[k]) - len(reads[k])))
                work.append((L, s, idxs, self.kband, self.adaptive))
        wave_budget = 2 * self._budget()
        while work:
            # flatten this round's chunks, then run them in WAVES: chunks
            # dispatch (and their transfers overlap) only while the wave's
            # combined device footprint stays inside 2x the memory budget.
            # Every dispatched chunk's op store + run-table workspace stays
            # referenced until its backtrace window is pulled in phase D,
            # so an unbounded dispatch list scales live memory with chunk
            # count; a single over-budget floor chunk (see _mem_cap) runs
            # as its own wave, matching the old chunk-serial peak.
            chunks = []
            for (L, smax, idxs, kband, adaptive) in work:
                cap = min(self.batch_size, self._mem_cap(L, smax, kband))
                for lo in range(0, len(idxs), cap):
                    chunks.append((L, smax, idxs[lo:lo + cap], kband,
                                   adaptive, cap))
            censored: dict = {}        # (L, smax) -> [indices]
            pos = 0
            while pos < len(chunks):
                # phase A: dispatch this wave's kernels (async under jit)
                t_a = time.time()
                disp = []
                used = 0
                while pos < len(chunks):
                    L, smax, chunk, kband, adaptive, cap = chunks[pos]
                    # DETERMINISTIC lane count: every chunk of a given
                    # (L, smax, kband) pads up to the same full cap, so
                    # escalation rounds (whose censored counts are data-
                    # dependent) never mint fresh jit shapes — tracing
                    # the while-loop kernels costs 0.1-0.5s per variant
                    # and was the real content of the convex "dispatch"
                    # phase (r5 probe: warm enqueue is ~5ms for 12
                    # chunks). Padding wastes at most one chunk's worth
                    # of device compute per round (~37ms at SV shapes)
                    # against a guaranteed re-trace save.
                    B = cap
                    nbytes = self._chunk_bytes(B, L, smax, kband)
                    if disp and used + nbytes > wave_budget:
                        break
                    used += nbytes
                    pos += 1
                    a = np.zeros((B, L), dtype=np.uint8)
                    b = np.zeros((B, L), dtype=np.uint8)
                    la = np.zeros(B, dtype=np.int32)
                    lb = np.zeros(B, dtype=np.int32)
                    for j, k in enumerate(chunk):
                        r, d = refs[k], reads[k]
                        a[j, :len(r)] = np.frombuffer(r, dtype=np.uint8)
                        b[j, :len(d)] = np.frombuffer(d, dtype=np.uint8)
                        la[j], lb[j] = len(r), len(d)
                    scores, ops = self._tb_kernel(
                        a, b, la, lb, L=L, smax=smax, kband=kband,
                        adaptive=adaptive)
                    disp.append([chunk, L, smax, kband, la, lb, scores,
                                 ops])
                self.phase_seconds["dispatch"] += time.time() - t_a
                # phase B: overlap every score transfer
                for d in disp:
                    try:
                        d[6].copy_to_host_async()
                    except Exception:
                        pass
                # phase C: run the backtrace walk ON DEVICE (one reverse
                # scan over the op store; wfa_walk_device) and ship only
                # the O(smax) per-lane op skeletons — pulling the
                # backtrace window [s*+1, B, 2s*+1] to a host walker was
                # ~75% of the engine wall on the SV/convex config
                # (BENCH_SECONDARY convex_phase_seconds, VERDICT r3
                # item 6). Only the score pull forces a sync per chunk.
                staged = []
                for (chunk, L, smax, kband, la, lb, scores, ops) in disp:
                    t_c = time.time()
                    sc = np.asarray(scores)[:len(chunk)]
                    self.phase_seconds["score_sync"] += time.time() - t_c
                    alive = sc <= smax
                    walk = None
                    if alive.any():
                        t_s = time.time()
                        walk = self._walk_dispatch(ops, scores, la, lb)
                        try:
                            walk[0].copy_to_host_async()
                        except Exception:
                            pass
                        self.phase_seconds["walk_dispatch"] = \
                            self.phase_seconds.get("walk_dispatch", 0.0) \
                            + time.time() - t_s
                    staged.append((chunk, L, smax, sc, la, lb, walk))
                del disp
                # phase D: pull skeletons, replay CIGARs on host
                for (chunk, L, smax, sc, la, lb, walk) in staged:
                    nrem = len(chunk)
                    if walk is None:
                        skeletons = [None] * nrem
                    else:
                        t_d = time.time()
                        skeletons = self._decode_walk(walk, nrem)
                        self.phase_seconds["window_pull"] += \
                            time.time() - t_d
                    t_w = time.time()
                    miss = censored.setdefault((L, smax), [])
                    for j, k in enumerate(chunk):
                        if skeletons[j] is None:
                            miss.append(k)
                            continue
                        cig = wfa_replay_cigar(refs[k], reads[k],
                                               skeletons[j],
                                               wildcards=self.wildcards)
                        ra, da = cigar_to_aligned(refs[k], reads[k], cig)
                        results[k] = (ra, da, cig, -float(sc[j]))
                        self.cells_filled += len(refs[k]) * len(reads[k])
                    self.phase_seconds["host_walk"] += time.time() - t_w
                del staged
            # next round: censored chunks retry at 2x the score ceiling
            # (wavefront work grows ~s^2, so 2x retries cost a bounded
            # geometric overhead where the old 4x jump paid 16x the
            # round-1 work at the first escalation), and WITHOUT the
            # heuristic band (a band censor may just mean the optimal
            # path wandered wide, not that the score is high)
            work = []
            for (L, smax), idxs in censored.items():
                if not idxs:
                    continue
                if smax > 2 * L:
                    fallback.extend(idxs)
                elif self.model == "affine" and \
                        self._chunk_bytes(32, L, smax * 2, None) > \
                        self._budget():
                    # escalation would blow the op-store budget: finish
                    # these on the O(s)-memory bialign engine instead
                    bialign_pool.extend(idxs)
                else:
                    work.append((L, smax * 2, idxs, None, None))
        if bialign_pool:
            outs = wfa_bialign_affine_pairs(
                [refs[k] for k in bialign_pool],
                [reads[k] for k in bialign_pool],
                x=self.x, o=self.o, e=self.e, wildcards=self.wildcards)
            for k, (pen, cig) in zip(bialign_pool, outs):
                ra, da = cigar_to_aligned(refs[k], reads[k], cig)
                results[k] = (ra, da, cig, -float(pen))
                self.cells_filled += len(refs[k]) * len(reads[k])
        self.device_seconds += time.time() - t0
        self.pairs_aligned += len(refs)
        if fallback:
            self._dp_fallback_fill(fallback, refs, reads, results)
        return results

    def _dp_fallback_fill(self, remaining, refs, reads, results):
        """Exact-DP fallback for pairs beyond the WFA score cap.

        The convex model keeps its gap semantics: censored affine2p pairs
        re-run the affine2p kernel at a guaranteed-sufficient ceiling
        (delete-all + insert-all bounds the minimal penalty) rather than
        silently switching to the single-affine DP; only ultra-long pairs
        (run table i16 limit) go to the DP fallback."""
        self.fallbacks += len(remaining)
        if self.model == "affine2p":
            # batch censored pairs by BUCKETED length with a quantized
            # guaranteed-sufficient ceiling so reruns reuse a small set
            # of compiled (32, L, smax) variants (every distinct shape is
            # a separate compile), and respect the
            # kernel memory budget: buckets whose ceiling op store would
            # blow CLIQUE_WFA_MEM_BUDGET go to the exact DP instead.
            long_pairs = []
            rerun_buckets: dict = {}
            for k in remaining:
                L = self._bucket_len(max(len(refs[k]), len(reads[k])))
                if L + 1 >= (1 << 15):
                    long_pairs.append(k)
                    continue
                rerun_buckets.setdefault(L, []).append(k)
            for L, idxs in rerun_buckets.items():
                smax = max(
                    min(2 * self.o + self.e * 2
                        * max(len(refs[k]), len(reads[k])),
                        2 * self.o2 + self.e2 * 2
                        * max(len(refs[k]), len(reads[k])))
                    for k in idxs) + 1
                smax = -(-smax // 1024) * 1024   # quantize the variant
                if self._chunk_bytes(32, L, smax) > self._budget():
                    long_pairs.extend(idxs)
                    continue
                for c0 in range(0, len(idxs), 32):
                    chunk = idxs[c0:c0 + 32]
                    a = np.zeros((32, L), dtype=np.uint8)
                    b = np.zeros((32, L), dtype=np.uint8)
                    la = np.zeros(32, dtype=np.int32)
                    lb = np.zeros(32, dtype=np.int32)
                    for j, k in enumerate(chunk):
                        a[j, :len(refs[k])] = np.frombuffer(refs[k],
                                                            dtype=np.uint8)
                        b[j, :len(reads[k])] = np.frombuffer(
                            reads[k], dtype=np.uint8)
                        la[j], lb[j] = len(refs[k]), len(reads[k])
                    sc, ops = self._tb_kernel(a, b, la, lb, L=L, smax=smax)
                    g = len(chunk)
                    walk = self._walk_dispatch(ops, sc, la, lb)
                    sc = np.asarray(sc)[:g]
                    skels = self._decode_walk(walk, g)
                    for j, k in enumerate(chunk):
                        cig = wfa_replay_cigar(refs[k], reads[k], skels[j],
                                               wildcards=self.wildcards)
                        ra, da = cigar_to_aligned(refs[k], reads[k], cig)
                        results[k] = (ra, da, cig, -float(sc[j]))
                        self.cells_filled += len(refs[k]) * len(reads[k])
            remaining = long_pairs
            if not remaining:
                return
        if self.dp_fallback is not None:
            out = self.dp_fallback.align_pairs(
                [refs[k] for k in remaining], [reads[k] for k in remaining])
            for k, r in zip(remaining, out):
                results[k] = r
        elif self.model == "affine" and all(
                _bialign_len_ok(max(len(refs[k]), len(reads[k])))
                for k in remaining):
            # no exact-DP engine attached: the O(s)-memory bialign driver
            # finishes these without the full-bound op store the direct
            # kernel would allocate
            outs = wfa_bialign_affine_pairs(
                [refs[k] for k in remaining],
                [reads[k] for k in remaining],
                x=self.x, o=self.o, e=self.e, wildcards=self.wildcards)
            for k, (pen, cig) in zip(remaining, outs):
                ra, da = cigar_to_aligned(refs[k], reads[k], cig)
                results[k] = (ra, da, cig, -float(pen))
                self.cells_filled += len(refs[k]) * len(reads[k])
        else:
            for k in remaining:
                (pen, cig), = wfa_affine_align_pairs(
                    [refs[k]], [reads[k]], x=self.x, o=self.o, e=self.e,
                    wildcards=self.wildcards)
                ra, da = cigar_to_aligned(refs[k], reads[k], cig)
                results[k] = (ra, da, cig, -float(pen))
                self.cells_filled += len(refs[k]) * len(reads[k])


def wfa_screen_candidates(refs, reads, *, x: int = 4, o: int = 6,
                          e: int = 2, smax: Optional[int] = None,
                          pad_to: int = 64, model: str = "affine",
                          o2: int = 24, e2: int = 1) -> np.ndarray:
    """Score-only candidate screen for exhaustive reference search: the
    WFA penalty of each (ref, read) pair, censored at smax (censored pairs
    return smax + 1 and rank last). One device dispatch per padded-length
    bucket. model="affine2p" screens under the dual-affine penalties so
    convex-engine ranking matches what the traceback pass will score."""
    if not refs:
        return np.zeros(0, dtype=np.int32)
    P = len(refs)
    L = max(pad_to, max(max(len(r) for r in refs),
                        max(len(d) for d in reads)))
    if smax is None:
        smax = max(64, L // 2)
    Ppad = 32
    while Ppad < P:
        Ppad *= 2
    a = np.zeros((Ppad, L), dtype=np.uint8)
    b = np.zeros((Ppad, L), dtype=np.uint8)
    la = np.zeros(Ppad, dtype=np.int32)
    lb = np.zeros(Ppad, dtype=np.int32)
    for i, (r, d) in enumerate(zip(refs, reads)):
        a[i, :len(r)] = np.frombuffer(r, dtype=np.uint8)
        b[i, :len(d)] = np.frombuffer(d, dtype=np.uint8)
        la[i], lb[i] = len(r), len(d)
    # score-only kernels: no [smax+1, B, K] op store is allocated for a
    # screen that never backtraces (on 180-candidate panels that store was
    # the dominant align allocation)
    if model == "affine2p":
        pen = wfa_affine2p_batch(a, b, la, lb, n1=L, n2=L, smax=smax,
                                 x=x, o1=o, e1=e, o2=o2, e2=e2,
                                 wildcards=True)
    else:
        pen = wfa_affine_batch(a, b, la, lb, n1=L, n2=L, smax=smax,
                               x=x, o=o, e=e, wildcards=True)
    return np.asarray(pen)[:P]


# --- host helpers ------------------------------------------------------------

def wfa_edit_distances(pairs_a, pairs_b, smax=None, pad_to: int = 64):
    """Host wrapper: exact edit distances via the wavefront kernel."""
    if not pairs_a:
        return np.zeros(0, dtype=np.int32)
    L = max(pad_to, max(max(len(a) for a in pairs_a),
                        max(len(b) for b in pairs_b)))
    P = len(pairs_a)
    Ppad = 32
    while Ppad < P:
        Ppad *= 2
    a = np.zeros((Ppad, L), dtype=np.uint8)
    b = np.zeros((Ppad, L), dtype=np.uint8)
    la = np.zeros(Ppad, dtype=np.int32)
    lb = np.zeros(Ppad, dtype=np.int32)
    for i, (s, t) in enumerate(zip(pairs_a, pairs_b)):
        a[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
        b[i, :len(t)] = np.frombuffer(t, dtype=np.uint8)
        la[i], lb[i] = len(s), len(t)
    if smax is None:
        smax = 2 * L
    return np.asarray(wfa_edit_batch(a, b, la, lb, n1=L, n2=L,
                                     smax=smax))[:P]
