"""Pair-HMM read routing: vectorized forward algorithm on device.

The north-star feature the reference README promises but never implements
(grep hmm/viterbi over /root/reference finds nothing - SURVEY section 1):
probabilistic routing of reads to amplicon references in multi-amplicon
panels, replacing brittle kmer votes for noisy ONT reads.

Model: a 3-state pair-HMM (Match / Insert / Delete) over (reference, read),
the probabilistic mirror of the affine-gap DP. The forward recursion has
the same anti-diagonal dependency structure as align/batch.py, so it runs
as the same [B, X]-per-step lax.scan - with logsumexp instead of max:

    M[x,y] = e_m(x,y) + LSE(M[x-1,y-1]+t_mm, I[x-1,y-1]+t_im, D[x-1,y-1]+t_dm)
    D[x,y] = e_d      + LSE(M[x-1,y]+t_md, D[x-1,y]+t_dd)
    I[x,y] = e_i(y)   + LSE(M[x,y-1]+t_mi, I[x,y-1]+t_ii)

Emissions handle the amplicon wildcard convention: reference digits /
symbols and N emit uniformly (log 1/4), real bases emit match_p / 3-way
mismatch. The total log-likelihood LSE(M,I,D at the corner) scores a
(reference, read) pair; routing takes the argmax over a panel.

Viterbi decoding is the existing max-plane DP (align/batch.py) with
log-probability scores - the same kernel.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = -1e30


@functools.partial(jax.jit, static_argnames=("n1", "n2"))
def hmm_forward_batch(
    refs: jax.Array,       # [B, n1-1] uint8
    reads: jax.Array,      # [B, n2-1] uint8
    ref_lens: jax.Array,   # [B]
    read_lens: jax.Array,  # [B]
    params: jax.Array,     # [6] f32: log_match, log_mismatch, log_wild,
                           #          log_gap_open, log_gap_extend, log_close
    *,
    n1: int,
    n2: int,
):
    """Batched forward log-likelihood; returns [B] f32."""
    B = refs.shape[0]
    D = n1 + n2 - 1
    f32 = jnp.float32

    lm, lx, lw, lgo, lge, lcl = [params[i] for i in range(6)]
    # transition log-probs (shared M->gap open, gap->gap extend, gap->M close)
    t_mm = jnp.log1p(-2.0 * jnp.exp(lgo))    # stay in match
    t_gap_open = lgo
    t_gap_ext = lge
    t_gap_close = jnp.log1p(-jnp.exp(lge))

    xs = jnp.arange(n1, dtype=jnp.int32)
    l1 = ref_lens[:, None].astype(jnp.int32)
    l2 = read_lens[:, None].astype(jnp.int32)
    refs_i = refs.astype(jnp.int32)
    reads_i = reads.astype(jnp.int32)

    def shift(v):
        return jnp.pad(v[:, :-1], ((0, 0), (1, 0)), constant_values=NEG)

    def lse3(a, b, c):
        m = jnp.maximum(a, jnp.maximum(b, c))
        return m + jnp.log(jnp.exp(a - m) + jnp.exp(b - m) + jnp.exp(c - m))

    def lse2(a, b):
        m = jnp.maximum(a, b)
        return m + jnp.log(jnp.exp(a - m) + jnp.exp(b - m))

    # hoist the per-row ref byte; read bytes come from a rolling window
    # (one-hot selects instead of per-step gathers inside the scan)
    rx_const = jnp.pad(refs_i[:, :n1 - 1], ((0, 0), (1, 0)))

    def step(carry, d):
        prev, prev2, final, win = carry
        pm, pi, pd = prev
        p2m, p2i, p2d = prev2

        x = jnp.broadcast_to(xs[None, :], (B, n1))
        y = jnp.broadcast_to(d - xs[None, :], (B, n1))

        rx = rx_const
        new_byte = jax.lax.dynamic_slice(
            reads_i, (0, jnp.clip(d - 1, 0, n2 - 2)), (B, 1))
        win = jnp.where(xs[None, :] == 0, new_byte,
                        jnp.pad(win[:, :-1], ((0, 0), (1, 0))))
        ry = win
        wild = (rx == 78) | (rx < 58) | (ry == 78)
        e_m = jnp.where(wild, lw, jnp.where(rx == ry, lm, lx))

        m_val = e_m + lse3(shift(p2m) + t_mm,
                           shift(p2i) + t_gap_close,
                           shift(p2d) + t_gap_close)
        d_val = lse2(shift(pm) + t_gap_open, shift(pd) + t_gap_ext)
        i_val = lse2(pm + t_gap_open, pi + t_gap_ext)

        is_origin = (x == 0) & (y == 0)
        inside = (x >= 1) & (x <= l1) & (y >= 1) & (y <= l2)
        m_out = jnp.where(is_origin, f32(0.0),
                          jnp.where(inside, m_val, f32(NEG)))
        d_out = jnp.where((y == 0) & (x >= 1) & (x <= l1),
                          lgo + (x.astype(f32) - 1.0) * lge,
                          jnp.where(inside, d_val, f32(NEG)))
        i_out = jnp.where((x == 0) & (y >= 1) & (y <= l2),
                          lgo + (y.astype(f32) - 1.0) * lge,
                          jnp.where(inside, i_val, f32(NEG)))

        on_corner = (l1[:, 0] + l2[:, 0]) == d
        # one-hot lane reduction: exactly one lane matches, so the sum
        # recovers its value exactly (even when negative)
        corner_lane = xs[None, :] == l1
        c_m, c_i, c_d = [
            jnp.sum(jnp.where(corner_lane, v, 0.0), axis=1)
            for v in (m_out, i_out, d_out)]
        ll = lse3(c_m, c_i, c_d)
        final = jnp.where(on_corner, ll, final)
        return ((m_out, i_out, d_out), prev, final, win), None

    neg = jnp.full((B, n1), NEG, dtype=f32)
    init = ((neg, neg, neg), (neg, neg, neg), jnp.full((B,), NEG, f32),
            jnp.zeros((B, n1), jnp.int32))
    (_, _, final, _w), _ = jax.lax.scan(step, init,
                                        jnp.arange(D, dtype=jnp.int32))
    return final


def default_hmm_params(match_p: float = 0.92, gap_open_p: float = 0.025,
                       gap_extend_p: float = 0.35) -> np.ndarray:
    """ONT-flavored emission/transition probabilities."""
    return np.array([
        math.log(match_p),
        math.log((1.0 - match_p) / 3.0),
        math.log(0.25),
        math.log(gap_open_p),
        math.log(gap_extend_p),
        math.log1p(-gap_extend_p),
    ], dtype=np.float32)


class HmmRouter:
    """Route reads to the best reference in a panel by forward LL."""

    def __init__(self, references: Sequence[bytes],
                 params: Optional[np.ndarray] = None,
                 length_quantum: int = 128):
        self.references = list(references)
        self.params = params if params is not None else default_hmm_params()
        self.quantum = length_quantum

    def _pad(self, n: int) -> int:
        q = self.quantum
        return max(q, -(-n // q) * q)

    def route(self, reads: Sequence[bytes],
              candidates: Optional[List[List[int]]] = None
              ) -> List[Tuple[int, float]]:
        """Returns per-read (best_reference_id, log_likelihood). candidates
        restricts the panel per read (e.g. from a kmer prefilter)."""
        R = len(self.references)
        pairs: List[Tuple[int, int]] = []  # (read_idx, ref_idx)
        for i, _read in enumerate(reads):
            cands = candidates[i] if candidates is not None else range(R)
            for r in cands:
                pairs.append((i, r))
        if not pairs:
            return [(-1, float("-inf"))] * len(reads)

        n1 = self._pad(max(len(r) for r in self.references) + 1)
        n2 = self._pad(max(len(d) for d in reads) + 1)
        out: List[Tuple[int, float]] = [(-1, float("-inf"))] * len(reads)
        CHUNK = 1024
        for c0 in range(0, len(pairs), CHUNK):
            chunk = pairs[c0:c0 + CHUNK]
            B = 32
            while B < len(chunk):
                B *= 2
            refs_arr = np.zeros((B, n1 - 1), dtype=np.uint8)
            reads_arr = np.zeros((B, n2 - 1), dtype=np.uint8)
            ref_lens = np.zeros(B, dtype=np.int32)
            read_lens = np.zeros(B, dtype=np.int32)
            for j, (i, r) in enumerate(chunk):
                rseq = self.references[r]
                dseq = reads[i]
                refs_arr[j, :len(rseq)] = np.frombuffer(rseq, dtype=np.uint8)
                reads_arr[j, :len(dseq)] = np.frombuffer(dseq, dtype=np.uint8)
                ref_lens[j] = len(rseq)
                read_lens[j] = len(dseq)
            ll = np.asarray(hmm_forward_batch(
                refs_arr, reads_arr, ref_lens, read_lens,
                jnp.asarray(self.params), n1=n1, n2=n2))
            for j, (i, r) in enumerate(chunk):
                if ll[j] > out[i][1]:
                    out[i] = (r, float(ll[j]))
        return out
