"""Batched tag-distance kernels (device) + candidate generation (host).

Device replacement for the reference's trie / VP-tree searches
(/root/reference/rust_cmd/src/umis/known_list.rs, rust_star's Trie and
LinkedDistances): tags are 8-16bp, so instead of pointer-chasing data
structures we brute-force distances on the device:

- Hamming vs an allowlist: one-hot encode both sides and contract them
  (tags [U, L*A] x allowlist [K, L*A]^T as int8->int32 matmuls);
  exact byte-class equality, so '-' == '-' and 'N' == 'N' count as matches
  exactly like FastaString::hamming_distance (known_list.rs:51-60).
- Levenshtein between candidate pairs: a score-only anti-diagonal DP over
  int16 lanes, thousands of pairs per dispatch.

For large multisets, pigeonhole piece-hashing bounds the candidate set the
same way the reference's trie pruning does: any two strings within edit
distance d share at least one of d+1 contiguous pieces (at a shift <= d for
indels), so a hash join on (piece index, shifted content) yields a candidate
superset that the exact device kernel then filters.
"""

from __future__ import annotations

import functools
import os
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# --- Levenshtein (score-only banded DP) -------------------------------------

@functools.partial(jax.jit, static_argnames=("L1", "L2"))
def _edit_distance_kernel(a, b, la, lb, *, L1: int, L2: int):
    """Pairwise edit distance: a [P, L1], b [P, L2] uint8; returns [P] i32."""
    P = a.shape[0]
    n1, n2 = L1 + 1, L2 + 1
    D = n1 + n2 - 1
    BIG = jnp.int32(1 << 20)

    xs = jnp.arange(n1, dtype=jnp.int32)
    a_i = a.astype(jnp.int32)
    b_i = b.astype(jnp.int32)
    la_c = la[:, None].astype(jnp.int32)
    lb_c = lb[:, None].astype(jnp.int32)

    def shift(v):
        return jnp.pad(v[:, :-1], ((0, 0), (1, 0)), constant_values=BIG)

    ax_const = jnp.pad(a_i[:, :n1 - 1], ((0, 0), (1, 0)))

    def step(carry, d):
        prev, prev2, final, win = carry
        x = jnp.broadcast_to(xs[None, :], (P, n1))
        y = jnp.broadcast_to(d - xs[None, :], (P, n1))

        ax = ax_const
        new_byte = jax.lax.dynamic_slice(
            b_i, (0, jnp.clip(d - 1, 0, L2 - 1)), (P, 1))
        win = jnp.where(xs[None, :] == 0, new_byte,
                        jnp.pad(win[:, :-1], ((0, 0), (1, 0))))
        by = win
        sub = jnp.where(ax == by, 0, 1)

        diag = shift(prev2) + sub
        up = shift(prev) + 1      # from (x-1, y)
        left = prev + 1           # from (x, y-1)
        val = jnp.minimum(diag, jnp.minimum(up, left))

        # borders
        val = jnp.where(y == 0, x, jnp.where(x == 0, y, val))
        # out-of-rectangle lanes poisoned
        val = jnp.where((y < 0) | (y >= n2), BIG, val).astype(jnp.int32)

        hit = (x == la_c) & (y == lb_c)
        final = jnp.where(jnp.any(hit, axis=1),
                          jnp.max(jnp.where(hit, val, 0), axis=1), final)
        return (val, prev, final, win), None

    init = (jnp.full((P, n1), BIG, jnp.int32),
            jnp.full((P, n1), BIG, jnp.int32),
            jnp.zeros((P,), jnp.int32),
            jnp.zeros((P, n1), jnp.int32))
    (prev, _, final, _w), _ = jax.lax.scan(step, init,
                                           jnp.arange(D, dtype=jnp.int32))
    # uint8 output: distances are <= L1+L2 << 255 here, and the
    # device->host payload stays small
    return jnp.minimum(final, 255).astype(jnp.uint8)


def _device_min_pairs() -> int:
    """Pair count below which edit distances run on the host bit-parallel
    kernel instead of a device dispatch. Tag workloads are tiny (1e3-1e5
    pairs x <=18bp), so small batches stay on the host. The 2,000,000
    default is not yet measured on the H100 (ROADMAP D3). Tunable via
    CLIQUE_TPU_EDIST_DEVICE_MIN_PAIRS."""
    return int(os.environ.get("CLIQUE_TPU_EDIST_DEVICE_MIN_PAIRS",
                              "2000000"))


def _edit_distance_myers_host(a: np.ndarray, b: np.ndarray,
                              la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    """Bit-parallel Myers/Hyyro Levenshtein on the host: a/b [P, >=L] uint8
    rows (content beyond la/lb ignored), lengths <= 64. One uint64 bit
    vector per pair, vectorized across pairs; exact-byte equality like
    _edit_distance_kernel. ~50M pair-steps/s in numpy - small tag batches
    finish in single-digit milliseconds with zero device latency."""
    P = a.shape[0]
    out = np.empty(P, dtype=np.uint8)
    if P == 0:
        return out
    la = la.astype(np.int64)
    lb = lb.astype(np.int64)
    L1 = int(la.max())
    L2 = int(lb.max())
    assert L1 <= 64 and L2 <= 255
    one = np.uint64(1)
    CH = 1 << 15  # chunk pairs to bound the per-chunk temporaries
    for s in range(0, P, CH):
        e = min(P, s + CH)
        n = e - s
        A = a[s:e, :max(L1, 1)]
        B = b[s:e, :max(L2, 1)]
        laa = la[s:e]
        lbb = lb[s:e]
        # Eq[p, j]: bitmask over pattern positions i < la with A[i] == B[j]
        # (built position-by-position: the [n, L1, L2] cube is 10x slower)
        Eq = np.zeros((n, max(L2, 1)), np.uint64)
        for i in range(L1):
            m = (A[:, i:i + 1] == B) & (i < laa)[:, None]
            Eq |= m.astype(np.uint64) << np.uint64(i)
        sh = np.where(laa < 64, laa, 0).astype(np.uint64)
        VP = np.where(laa == 64, ~np.uint64(0), (one << sh) - one)
        VP = np.where(laa == 0, np.uint64(0), VP)
        VN = np.zeros(n, np.uint64)
        score = laa.copy()
        mbit = one << np.where(laa > 0, laa - 1, 0).astype(np.uint64)
        for j in range(L2):
            act = (j < lbb) & (laa > 0)
            PM = Eq[:, j]
            D0 = (((PM & VP) + VP) ^ VP) | PM | VN
            HP = VN | ~(D0 | VP)
            HN = VP & D0
            score += (act & ((HP & mbit) != 0)).astype(np.int64)
            score -= (act & ((HN & mbit) != 0)).astype(np.int64)
            HP = (HP << one) | one
            HN = HN << one
            nVP = HN | ~(D0 | HP)
            nVN = HP & D0
            VP = np.where(act, nVP, VP)
            VN = np.where(act, nVN, VN)
        score = np.where(laa == 0, lbb, score)
        out[s:e] = np.minimum(score, 255).astype(np.uint8)
    return out


def edit_distance_pairs(seqs_a: Sequence[bytes], seqs_b: Sequence[bytes],
                        pad_to: int = 32) -> np.ndarray:
    """Exact Levenshtein distance for each (seqs_a[i], seqs_b[i]) pair.

    The pair count is padded to the next power of two (min 256) so repeated
    calls reuse a handful of compiled kernel shapes."""
    assert len(seqs_a) == len(seqs_b)
    if not seqs_a:
        return np.zeros(0, dtype=np.int32)
    L = max(pad_to, max(max(len(s) for s in seqs_a),
                        max(len(s) for s in seqs_b)))
    P = len(seqs_a)
    Ppad = 256
    while Ppad < P:
        Ppad *= 2
    pad_rows = Ppad - P

    def marshal(seqs, lens):
        lens_p = lens[:P]
        if (lens_p == L).all():
            # uniform-length fast path: one C-speed join, no per-string pad
            flat = b"".join(seqs) + b"\x00" * (L * pad_rows)
            return np.frombuffer(flat, dtype=np.uint8).reshape(Ppad, L)
        # mixed lengths: one join + block assignment per distinct length
        # (typically 2-3 distinct values) instead of a per-string ljust
        arr = np.zeros((Ppad, L), dtype=np.uint8)
        for g in np.unique(lens_p):
            if g == 0:
                continue
            idx = np.flatnonzero(lens_p == g)
            sub = np.frombuffer(b"".join([seqs[i] for i in idx]),
                                dtype=np.uint8).reshape(len(idx), int(g))
            arr[idx, :g] = sub
        return arr

    la = np.zeros(Ppad, dtype=np.int32)
    lb = np.zeros(Ppad, dtype=np.int32)
    la[:P] = np.fromiter(map(len, seqs_a), np.int32, count=P)
    lb[:P] = np.fromiter(map(len, seqs_b), np.int32, count=P)
    a = marshal(seqs_a, la)
    b = marshal(seqs_b, lb)
    if L <= 64 and P < _device_min_pairs():
        return _edit_distance_myers_host(a[:P], b[:P], la[:P], lb[:P])
    return np.asarray(_edit_distance_kernel(a, b, la, lb, L1=L, L2=L))[:P]


def edit_distance_rows(a: np.ndarray, b: np.ndarray, la: np.ndarray,
                       lb: np.ndarray) -> np.ndarray:
    """Exact Levenshtein per row pair, already-marshalled inputs:
    a/b [P, L] uint8 (content beyond la/lb ignored), la/lb [P] lengths.
    Row count padded to powers of two (min 256) for shape reuse."""
    P, L = a.shape
    if P == 0:
        return np.zeros(0, dtype=np.uint8)
    if L <= 64 and P < _device_min_pairs():
        return _edit_distance_myers_host(a, b, la, lb)
    Ppad = 256
    while Ppad < P:
        Ppad *= 2
    if Ppad != P:
        a = np.pad(a, ((0, Ppad - P), (0, 0)))
        b = np.pad(b, ((0, Ppad - P), (0, 0)))
        la = np.pad(la, (0, Ppad - P))
        lb = np.pad(lb, (0, Ppad - P))
    return np.asarray(_edit_distance_kernel(
        a, b, la.astype(np.int32), lb.astype(np.int32), L1=L, L2=L))[:P]


# --- Hamming vs allowlist as an int8 one-hot product -------------------------

def _byte_classes(arrays: List[np.ndarray]) -> Tuple[np.ndarray, int]:
    """Map the distinct byte values present to small class ids."""
    values = np.unique(np.concatenate([a.ravel() for a in arrays]))
    lut = np.zeros(256, dtype=np.int32)
    for i, v in enumerate(values):
        lut[v] = i
    return lut, len(values)


@functools.partial(jax.jit, static_argnames=("n_classes",))
def _match_count_kernel(tags_cls, allow_cls, *, n_classes: int):
    """tags_cls [U, L] i32, allow_cls [K, L] i32 -> matches [U, K] u8
    (match counts are <= L <= 255; uint8 keeps transfers small)."""
    t_oh = jax.nn.one_hot(tags_cls, n_classes, dtype=jnp.int8)   # [U, L, A]
    a_oh = jax.nn.one_hot(allow_cls, n_classes, dtype=jnp.int8)  # [K, L, A]
    U, L, A = t_oh.shape
    K = a_oh.shape[0]
    m = jax.lax.dot_general(
        t_oh.reshape(U, L * A), a_oh.reshape(K, L * A),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)
    return jnp.minimum(m, 255).astype(jnp.uint8)


def hamming_hits(tags: List[bytes], allowlist: List[bytes], max_distance: int,
                 chunk_u: int = 2048, chunk_k: int = 16384
                 ) -> List[List[int]]:
    """For each equal-length tag, indices of allowlist entries within Hamming
    radius max_distance (exact byte equality per column, as
    FastaString::hamming_distance)."""
    if not tags or not allowlist:
        return [[] for _ in tags]
    L = len(allowlist[0])
    assert all(len(t) == L for t in tags), "hamming requires equal lengths"
    assert all(len(a) == L for a in allowlist)

    tags_a = np.frombuffer(b"".join(tags), dtype=np.uint8).reshape(-1, L)
    allow_a = np.frombuffer(b"".join(allowlist), dtype=np.uint8).reshape(-1, L)
    lut, n_classes = _byte_classes([tags_a, allow_a])
    tags_c = lut[tags_a]
    allow_c = lut[allow_a]

    def pad_rows(arr, to):
        if arr.shape[0] == to:
            return arr
        return np.pad(arr, ((0, to - arr.shape[0]), (0, 0)))

    out: List[List[int]] = []
    for u0 in range(0, len(tags), chunk_u):
        t_chunk = tags_c[u0:u0 + chunk_u]
        n_u = len(t_chunk)
        u_pad = 256
        while u_pad < n_u:
            u_pad *= 2
        hits_chunk: List[List[int]] = [[] for _ in range(n_u)]
        for k0 in range(0, len(allowlist), chunk_k):
            a_chunk = allow_c[k0:k0 + chunk_k]
            n_k = len(a_chunk)
            k_pad = 256
            while k_pad < n_k:
                k_pad *= 2
            matches = np.asarray(_match_count_kernel(
                pad_rows(t_chunk, u_pad), pad_rows(a_chunk, k_pad),
                n_classes=n_classes))[:n_u, :n_k]
            dist = L - matches
            uu, kk = np.nonzero(dist <= max_distance)
            for u, k in zip(uu, kk):
                hits_chunk[u].append(k0 + int(k))
        out.extend(hits_chunk)
    return out


# --- pigeonhole candidate generation ----------------------------------------

def _emit_groups(inv: np.ndarray):
    """Yield (start, end, order) group slices of equal inverse ids."""
    order = np.argsort(inv, kind="stable")
    s = inv[order]
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    ends = np.r_[starts[1:], len(s)]
    return starts, ends, order


def _piece_keys(a: np.ndarray):
    """Globally comparable scalar keys for byte-block rows: pieces of <= 8
    bytes pack into uint64 (much faster to sort/group than row-wise
    np.unique); wider pieces return None and callers fall back to
    np.unique(axis=0) ids."""
    w = a.shape[1]
    if w > 8:
        return None
    k = np.zeros(a.shape[0], dtype=np.uint64)
    for c in range(w):
        k = (k << np.uint64(8)) | a[:, c].astype(np.uint64)
    return k


def _join_pairs(keys0: np.ndarray, keys1: np.ndarray, sorted0=None):
    """All (row0, row1) index pairs with keys0[row0] == keys1[row1], via
    one sort + searchsorted join — no per-bucket python loops (the
    per-group triu/cross emission dominated collapse host time at ~10k
    distinct cell tags). `sorted0` lets callers reuse keys0's
    (order, sorted keys) across many keys1 probes (int32 rows: candidate
    sets are unique-tag indices, far below 2^31)."""
    if sorted0 is None:
        order0 = np.argsort(keys0, kind="stable").astype(np.int32)
        k0s = keys0[order0]
    else:
        order0, k0s = sorted0
    left = np.searchsorted(k0s, keys1, "left").astype(np.int32)
    right = np.searchsorted(k0s, keys1, "right").astype(np.int32)
    cnt = right - left
    total = int(cnt.sum())
    if total == 0:
        return None
    offs = np.cumsum(cnt, dtype=np.int64) - cnt
    intra = (np.arange(total, dtype=np.int64)
             - np.repeat(offs, cnt)).astype(np.int32)
    rows0 = order0[np.repeat(left, cnt) + intra]
    rows1 = np.repeat(np.arange(len(keys1), dtype=np.int32), cnt)
    return rows0, rows1


def _candidate_pairs_np(tags: List[bytes], max_distance: int,
                        counts: "np.ndarray" = None,
                        ratio: float = None) -> List[Tuple[int, int]]:
    """Vectorized pigeonhole for equal-length tags: byte-block packed keys
    + flat searchsorted joins replace per-tag dict bucketing and
    per-bucket pair loops.

    With (counts, ratio): only pairs that can matter to ratio absorption
    are generated. A qualifying pair needs max(ci, cj) >= ratio * min(ci,
    cj) >= ratio * counts.min(), so one side always lies in the small
    high-count set H = {i: counts[i] >= ratio * cmin}; joining ALL x H
    (both unshifted/shifted directions) is an exact superset of
    qualifying pairs while skipping the count-1 x count-1 mass — the term
    that made candidate generation quadratic in reads (each cell
    barcode's error halo pairs internally within distance 2d). Callers
    re-apply the exact (ci != cj) & ratio filter, so results are
    identical to the unrestricted join."""
    N = len(tags)
    L = len(tags[0])
    arr = np.frombuffer(b"".join(tags), dtype=np.uint8).reshape(N, L)
    n_pieces = max_distance + 1
    bounds = [round(i * L / n_pieces) for i in range(n_pieces + 1)]
    enc_chunks: List[np.ndarray] = []

    hmask = None
    if counts is not None and ratio is not None and N:
        counts = np.asarray(counts, dtype=np.int64)
        hset = np.flatnonzero(counts >= ratio * counts.min()).astype(
            np.int32)
        # the restricted path pays two joins per probe; only worth it
        # when H is genuinely sparse
        if len(hset) * 4 <= N:
            hmask = hset

    def _emit(r0: np.ndarray, r1: np.ndarray) -> None:
        # unordered (lo, hi) pairs packed straight into the int64 dedupe
        # encoding — no [P, 2] stack per join
        lo_i = np.minimum(r0, r1).astype(np.int64)
        enc_chunks.append(lo_i * N + np.maximum(r0, r1))

    for p in range(n_pieces):
        lo, hi = bounds[p], bounds[p + 1]
        if hi <= lo:
            continue
        a0 = arr[:, lo:hi]
        k0 = _piece_keys(a0)
        if k0 is None:
            _u, k0 = np.unique(a0, axis=0, return_inverse=True)
        order0 = np.argsort(k0, kind="stable").astype(np.int32)
        sorted0 = (order0, k0[order0])      # reused across every probe
        # same-piece buckets: self-join, keep each unordered pair once.
        # Count-restricted: ALL x H covers every qualifying pair (the
        # high side is in H by construction).
        if hmask is not None:
            j = _join_pairs(k0, k0[hmask], sorted0=sorted0)
            if j is not None:
                r0, r1 = j
                r1 = hmask[r1]
                keep = r0 != r1
                if keep.any():
                    _emit(r0[keep], r1[keep])
        else:
            j = _join_pairs(k0, k0, sorted0=sorted0)
            if j is not None:
                r0, r1 = j
                keep = r0 < r1
                if keep.any():
                    _emit(r0[keep], r1[keep])
        # shifted pieces join against the unshifted buckets. EQUAL-length
        # strings at Levenshtein <= d pair every insertion with a
        # deletion, so the alignment offset at any point is bounded by
        # floor(d/2) — shifts beyond that cannot witness a real pair
        # (the ragged fallback path keeps the full +-d range)
        max_shift = max_distance // 2
        for s in range(-max_shift, max_shift + 1):
            if s == 0 or lo + s < 0 or hi + s > L:
                continue
            a_s = arr[:, lo + s:hi + s]
            k_s = _piece_keys(a_s)
            if k_s is None:
                _u, invb = np.unique(np.vstack([a0, a_s]), axis=0,
                                     return_inverse=True)
                kk0, kk1 = invb[:N], invb[N:]
                if hmask is not None:
                    # clean piece on either side: (ALL unshifted x H
                    # shifted) + (H unshifted x ALL shifted)
                    j = None
                    ja = _join_pairs(kk0, kk1[hmask])
                    if ja is not None:
                        r0, r1 = ja
                        r1 = hmask[r1]
                        keep = r0 != r1
                        if keep.any():
                            _emit(r1[keep], r0[keep])
                    jb = _join_pairs(kk0[hmask], kk1)
                    if jb is not None:
                        r0, r1 = jb
                        r0 = hmask[r0]
                        keep = r0 != r1
                        if keep.any():
                            _emit(r1[keep], r0[keep])
                else:
                    j = _join_pairs(kk0, kk1)
            else:
                # same width as a0, so k0 holds packed (comparable) keys
                if hmask is not None:
                    j = None
                    ja = _join_pairs(k0, k_s[hmask], sorted0=sorted0)
                    if ja is not None:
                        r0, r1 = ja
                        r1 = hmask[r1]
                        keep = r0 != r1
                        if keep.any():
                            _emit(r1[keep], r0[keep])
                    # H's unshifted pieces vs everyone's shifted windows:
                    # sort the H-restricted keys once per probe
                    jb = _join_pairs(k0[hmask], k_s)
                    if jb is not None:
                        r0, r1 = jb
                        r0 = hmask[r0]
                        keep = r0 != r1
                        if keep.any():
                            _emit(r1[keep], r0[keep])
                else:
                    j = _join_pairs(k0, k_s, sorted0=sorted0)
            if j is not None:
                r0, r1 = j
                keep = r0 != r1
                if keep.any():
                    _emit(r1[keep], r0[keep])

    if not enc_chunks:
        return np.zeros((0, 2), dtype=np.int64)
    enc = np.unique(np.concatenate(enc_chunks))
    return np.stack([enc // N, enc % N], axis=1)

def _pieces(seq: bytes, n_pieces: int) -> List[Tuple[int, bytes]]:
    L = len(seq)
    bounds = [round(i * L / n_pieces) for i in range(n_pieces + 1)]
    return [(i, seq[bounds[i]:bounds[i + 1]]) for i in range(n_pieces)]


def candidate_pairs_array(tags: List[bytes], max_distance: int,
                          counts: "np.ndarray" = None,
                          ratio: float = None) -> np.ndarray:
    """candidate_pairs returning an [P, 2] i64 ndarray directly (no python
    tuple round-trip) — the form degenerate_prepare consumes. counts/ratio
    (optional, equal-length path only) restrict the superset to pairs that
    can pass ratio absorption — see _candidate_pairs_np."""
    if tags and len({len(t) for t in tags}) == 1:
        return _candidate_pairs_np(tags, max_distance, counts=counts,
                                   ratio=ratio)
    return np.array(candidate_pairs(tags, max_distance),
                    dtype=np.int64).reshape(-1, 2)


def candidate_pairs(tags: List[bytes], max_distance: int) -> List[Tuple[int, int]]:
    """Superset of all pairs within edit distance max_distance, via the
    d+1-piece pigeonhole with +-d shifts (indel tolerance).

    Equal-length tag sets (the common case: normalize_tag pads) take a
    vectorized numpy path; ragged sets fall back to the dict build."""
    if tags and len({len(t) for t in tags}) == 1:
        arr = _candidate_pairs_np(tags, max_distance)
        return list(zip(arr[:, 0].tolist(), arr[:, 1].tolist()))
    n_pieces = max_distance + 1
    buckets: Dict[Tuple[int, int, bytes], List[int]] = defaultdict(list)
    for idx, t in enumerate(tags):
        L = len(t)
        bounds = [round(i * L / n_pieces) for i in range(n_pieces + 1)]
        for p in range(n_pieces):
            lo, hi = bounds[p], bounds[p + 1]
            for shift in range(-max_distance, max_distance + 1):
                s, e = lo + shift, hi + shift
                if s < 0 or e > L:
                    continue
                buckets[(p, shift, t[s:e])].append(idx)
    pairs = set()
    for (p, shift, _piece), members in buckets.items():
        if shift != 0:
            continue
        for i in members:
            pairs.update((min(i, j), max(i, j)) for j in members if j != i)
    # shifted pieces join against unshifted ones
    unshifted: Dict[Tuple[int, bytes], List[int]] = defaultdict(list)
    for (p, shift, piece), members in buckets.items():
        if shift == 0:
            unshifted[(p, piece)].extend(members)
    for (p, shift, piece), members in buckets.items():
        if shift == 0:
            continue
        base = unshifted.get((p, piece))
        if not base:
            continue
        for i in members:
            pairs.update((min(i, j), max(i, j)) for j in base if j != i)
    return sorted(pairs)


def candidates_to_allowlist(tags: List[bytes], allowlist: List[bytes],
                            max_distance: int) -> List[List[int]]:
    """For each tag, allowlist indices sharing a pigeonhole piece (candidate
    superset for Levenshtein <= max_distance matching)."""
    n_pieces = max_distance + 1
    index: Dict[Tuple[int, bytes], List[int]] = defaultdict(list)
    for k, a in enumerate(allowlist):
        for p, piece in _pieces(a, n_pieces):
            index[(p, piece)].append(k)
    out: List[List[int]] = []
    for t in tags:
        L = len(t)
        bounds = [round(i * L / n_pieces) for i in range(n_pieces + 1)]
        cands = set()
        for p in range(n_pieces):
            lo, hi = bounds[p], bounds[p + 1]
            for shift in range(-max_distance, max_distance + 1):
                s, e = lo + shift, hi + shift
                if s < 0 or e > L:
                    continue
                cands.update(index.get((p, t[s:e]), ()))
        out.append(sorted(cands))
    return out
