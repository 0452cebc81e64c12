"""Tag correction: known-list matching and de-novo (starcode-style)
clustering.

Re-derivation of the reference's SequenceCorrector closers
(/root/reference/rust_cmd/src/umis/correct_tags.rs:122-332) with the search
structures replaced by device distance kernels (collapse/distance.py):

- correct_known_hamming: VP-tree radius search -> int8 one-hot matmul;
  accept iff exactly one allowlist entry within Hamming max_distance
  (known_list.rs:123-167).
- correct_known_levenshtein: rust_star trie chained search -> pigeonhole
  candidates + batched device Levenshtein; unique hit accepted, multi-hit
  accepted iff a unique minimum distance (correct_tags.rs:182-239).
- correct_degenerate: rust_star LinkedDistances starcode clustering ->
  candidate pairs + device Levenshtein + greedy count-ratio absorption
  (bigger cluster absorbs smaller when count_big/count_small >=
  minimum_collapsing_difference, default 5.0) with swallowed-link
  transitivity (correct_tags.rs:256-332).

All corrections key on the gap-stripped tag padded with '-' to the
configured length (correct_tags.rs:162-169, 341-348).
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from clique_tpu.collapse.distance import (
    candidate_pairs,
    candidate_pairs_array,
    candidates_to_allowlist,
    edit_distance_pairs,
    hamming_hits,
)

GAP = ord("-")


def tag_consensus(seqs) -> bytes:
    """Per-column majority over equal-length byte strings with N/'-'
    losing ties to real bases (collapse.rs consensus :1033-1072; the
    reference's HashMap iteration makes real-base ties nondeterministic —
    we break them by first appearance, deterministically)."""
    n = len(seqs[0])
    out = bytearray()
    for i in range(n):
        counts: Dict[int, int] = {}
        order: List[int] = []
        for s in seqs:
            assert len(s) == n, "consensus inputs must share a length"
            b = s[i]
            if b not in counts:
                order.append(b)
            counts[b] = counts.get(b, 0) + 1
        mx = max(counts.values())
        best = [b for b in order if counts[b] == mx]
        real = [b for b in best if b not in (ord("N"), GAP)]
        out.append(real[0] if real else best[0])
    return bytes(out)


def normalize_tag(tag: bytes, length: int) -> bytes:
    """Gap-strip then right-pad with '-' to `length` (longer tags keep their
    length), as correct_tags.rs:162-169."""
    stripped = tag.replace(b"-", b"")
    if len(stripped) < length:
        return stripped.ljust(length, b"-")
    return stripped


def correct_known_hamming(counts: Dict[bytes, int], allowlist: List[bytes],
                          max_distance: int, length: int) -> Dict[bytes, bytes]:
    """KnownList::correct_all semantics: pad tags to `length`, radius search,
    accept unique hits only. Keys of the result are the RAW observed tags
    (known_list.rs:128-141 keys corrections by the unpadded barcode)."""
    if not counts or not allowlist:
        return {}
    tags = list(counts.keys())
    padded = [t + b"-" * (length - len(t)) if len(t) < length else t
              for t in tags]
    # allowlist entries are used as-is (reference asserts equal length)
    usable = [(i, t) for i, t in enumerate(padded)
              if len(t) == len(allowlist[0])]
    hits = hamming_hits([t for _i, t in usable], allowlist, max_distance)
    out: Dict[bytes, bytes] = {}
    for (i, _t), hit in zip(usable, hits):
        if len(hit) == 1:
            out[tags[i]] = allowlist[hit[0]]
    return out


def correct_known_levenshtein(counts: Dict[bytes, int], allowlist: List[bytes],
                              max_distance: int, length: int
                              ) -> Dict[bytes, bytes]:
    """Trie chained-search semantics: tags matched against the allowlist by
    Levenshtein distance <= max_distance; unique hit accepted; multiple hits
    accepted iff one has the strictly minimal distance. Result keys are the
    normalized (gap-stripped, padded) tags (correct_tags.rs:162-186)."""
    if not counts or not allowlist:
        return {}
    tags = sorted(counts.keys())
    norm = [normalize_tag(t, length) for t in tags]
    cands = candidates_to_allowlist(norm, allowlist, max_distance)

    pair_a: List[bytes] = []
    pair_b: List[bytes] = []
    owners: List[Tuple[int, int]] = []
    for i, cand in enumerate(cands):
        for k in cand:
            pair_a.append(norm[i])
            pair_b.append(allowlist[k])
            owners.append((i, k))
    dists = edit_distance_pairs(pair_a, pair_b)

    per_tag: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for (i, k), d in zip(owners, dists):
        if d <= max_distance:
            per_tag[i].append((int(d), k))

    out: Dict[bytes, bytes] = {}
    for i, hits in per_tag.items():
        if len(hits) == 1:
            out[norm[i]] = allowlist[hits[0][1]]
        else:
            dmin = min(d for d, _k in hits)
            minimal = [k for d, k in hits if d == dmin]
            if len(minimal) == 1:
                out[norm[i]] = allowlist[minimal[0]]
    return out


_TRIU_CACHE: Dict[int, np.ndarray] = {}
_TRIU_CACHE_BYTES = [0]
_TRIU_CACHE_BUDGET = 64 << 20        # total resident bytes
_TRIU_ENTRY_CAP = 8 << 20            # don't cache huge sizes (n ~> 1000)


def _triu_pairs(n: int) -> np.ndarray:
    """All (i, j<i) index pairs as one [P, 2] i64 array, cached by n —
    sort_level calls degenerate_prepare once per UMI bin, and bins within a
    level share a handful of sizes. The cache is byte-bounded: only small
    arrays (the common repeated sizes) are kept, and the whole cache clears
    past a fixed budget — a level with hundreds of distinct large sizes
    must not pin gigabytes of index arrays."""
    hit = _TRIU_CACHE.get(n)
    if hit is None:
        ii, jj = np.triu_indices(n, 1)
        hit = np.stack([ii, jj], axis=1).astype(np.int64)
        if hit.nbytes <= _TRIU_ENTRY_CAP:
            if _TRIU_CACHE_BYTES[0] + hit.nbytes > _TRIU_CACHE_BUDGET:
                _TRIU_CACHE.clear()
                _TRIU_CACHE_BYTES[0] = 0
            _TRIU_CACHE[n] = hit
            _TRIU_CACHE_BYTES[0] += hit.nbytes
    return hit


def degenerate_prepare(counts: Dict[bytes, int], max_distance: int,
                       length: int, collapse_ratio: float = 5.0):
    """Stage 1 of correct_degenerate: normalize tags, build the padded tag
    matrix and the candidate-pair index array. Returns
    (norm_counts, tags, mat [T, max_len] u8, pairs [P, 2] i64, ready);
    ready is the finished map for the trivial 0/1-tag cases.

    Pairs are pre-filtered by the absorption rule BEFORE any distance is
    computed: a pair can only matter when the counts differ and the ratio
    reaches collapse_ratio (degenerate_finish skips everything else), so
    the dominant count-1-vs-count-1 error-tag pairs never reach the device
    kernel - exact, and cuts the level-0 distance batch ~10x."""
    if not counts:
        return None, None, None, None, {}
    norm_counts: Counter = Counter()
    for tag, c in counts.items():
        norm_counts[normalize_tag(tag, length)] += c
    tags = list(norm_counts.keys())
    if len(tags) == 1:
        return None, None, None, None, {tags[0]: tags[0]}
    mat, pairs = _prepare_pairs(norm_counts, tags, max_distance,
                                collapse_ratio)
    return norm_counts, tags, mat, pairs, None


def _prepare_pairs(norm_counts, tags, max_distance: int,
                   collapse_ratio: float):
    """Tag matrix + count-ratio-filtered candidate pairs for an
    already-normalized multi-tag group (shared by degenerate_prepare and
    the batched correct_degenerate_groups odd path, so pair indices always
    refer to the SAME tag ordering the caller holds)."""
    lens = np.fromiter(map(len, tags), np.int64, count=len(tags))
    max_len = int(lens.max())
    if (lens == max_len).all():
        mat = np.frombuffer(b"".join(tags), dtype=np.uint8
                            ).reshape(len(tags), max_len)
    else:
        mat = np.full((len(tags), max_len), GAP, dtype=np.uint8)
        for g in np.unique(lens):
            idx = np.flatnonzero(lens == g)
            mat[idx, :g] = np.frombuffer(
                b"".join([tags[i] for i in idx]), dtype=np.uint8
            ).reshape(len(idx), int(g))
    cnt = np.fromiter((norm_counts[t] for t in tags), np.int64,
                      count=len(tags))
    if len(tags) <= 4096:
        pairs = _count_filtered_pairs(cnt, collapse_ratio)
        if pairs is None:
            pairs = _triu_pairs(len(tags))
    else:
        padded = [t + b"-" * (max_len - len(t)) for t in tags]
        pairs = candidate_pairs_array(padded, max_distance, counts=cnt,
                                      ratio=collapse_ratio)
    ci, cj = cnt[pairs[:, 0]], cnt[pairs[:, 1]]
    hi = np.maximum(ci, cj)
    lo = np.minimum(ci, cj)
    pairs = pairs[(ci != cj) & (hi >= collapse_ratio * lo)]
    return mat, pairs


def _count_filtered_pairs(cnt: np.ndarray,
                          collapse_ratio: float) -> Optional[np.ndarray]:
    """H x ALL cross-product pair indices for one group: every pair that
    can pass ratio absorption has its high side in H = {i: cnt[i] >=
    ratio * cnt.min()} (see _candidate_pairs_np), so when H is small this
    [h*T, 2] array is an exact-superset replacement for the [T*(T-1)/2]
    triu — the all-pairs term was quadratic in per-bin error variants.
    Returns None when H is too big to beat triu (callers keep triu).
    May contain (i, i) self-rows and (a, b)/(b, a) duplicates for pairs
    within H; both are harmless — self-rows fail the ci != cj filter and
    duplicate absorption links are idempotent in degenerate_finish."""
    T = len(cnt)
    hset = np.flatnonzero(cnt >= collapse_ratio * cnt.min())
    h = len(hset)
    if h * 2 >= T - 1:
        return None
    left = np.repeat(hset.astype(np.int64), T)
    right = np.tile(np.arange(T, dtype=np.int64), h)
    return np.stack([left, right], axis=1)


def degenerate_finish(norm_counts, tags, pairs, dists, max_distance: int,
                      collapse_ratio: float) -> Dict[bytes, bytes]:
    """Stage 2: ratio absorption + transitive resolution given pair
    distances. pairs [P, 2] i64, dists [P]."""
    close = pairs[np.asarray(dists) <= max_distance]
    parent = list(range(len(tags)))

    def better_absorber(a: int, cur: int) -> bool:
        ca, cc = norm_counts[tags[a]], norm_counts[tags[cur]]
        return ca > cc or (ca == cc and tags[a] < tags[cur])

    for i, j in close.tolist():
        ci, cj = norm_counts[tags[i]], norm_counts[tags[j]]
        if ci == cj:
            continue
        a, b = (i, j) if ci > cj else (j, i)
        ca, cb = max(ci, cj), min(ci, cj)
        if ca / cb >= collapse_ratio:
            if parent[b] == b or better_absorber(a, parent[b]):
                parent[b] = a

    def root(i: int) -> int:
        seen = set()
        while parent[i] != i and i not in seen:
            seen.add(i)
            i = parent[i]
        return i

    return {tags[i]: tags[root(i)] for i in range(len(tags))}


def correct_degenerate_groups(group_counts, max_distance: int, length: int,
                              collapse_ratio: float = 5.0):
    """Batched correct_degenerate over many groups: one device distance
    call for every group's candidate pairs combined (per-group device
    dispatches dominate wall-clock on high-latency links), and ONE flat
    preparation pass — groups whose normalized tags all have the standard
    length share a single tag matrix, cached-triu pair index array, and
    count-ratio pre-filter (the per-group numpy constants of
    degenerate_prepare dominated the level's host time at ~1k bins)."""
    from clique_tpu.collapse.distance import edit_distance_rows

    n_groups = len(group_counts)
    results: List[Optional[Dict[bytes, bytes]]] = [None] * n_groups
    norm_list: List[Optional[Counter]] = [None] * n_groups
    tag_lists: List[Optional[List[bytes]]] = [None] * n_groups
    flat: List[int] = []       # uniform-length multi-tag groups
    odd: List[int] = []        # fall back to degenerate_prepare
    for gi, counts in enumerate(group_counts):
        if not counts:
            results[gi] = {}
            continue
        nc: Counter = Counter()
        for tag, c in counts.items():
            nc[normalize_tag(tag, length)] += c
        norm_list[gi] = nc
        tags = list(nc.keys())
        tag_lists[gi] = tags
        if len(tags) == 1:
            results[gi] = {tags[0]: tags[0]}
        elif len(tags) <= 4096 and all(len(t) == length for t in tags):
            flat.append(gi)
        else:
            odd.append(gi)

    # --- flat path: one matrix + one pair array across all groups -----------
    seg_A = seg_B = None
    flat_pairs = flat_bounds = None
    if flat:
        sizes = np.fromiter((len(tag_lists[gi]) for gi in flat), np.int64,
                            count=len(flat))
        offs = np.concatenate(([0], np.cumsum(sizes)))
        mat = np.frombuffer(
            b"".join(t for gi in flat for t in tag_lists[gi]),
            dtype=np.uint8).reshape(int(offs[-1]), length)
        cnt = np.fromiter(
            (c for gi in flat for c in norm_list[gi].values()),
            np.int64, count=int(offs[-1]))
        pair_chunks = []
        pair_group = []
        for k, gi in enumerate(flat):
            cnt_g = cnt[offs[k]:offs[k + 1]]
            p = _count_filtered_pairs(cnt_g, collapse_ratio)
            if p is None:
                p = _triu_pairs(int(sizes[k]))
            pair_chunks.append(p + offs[k])
            pair_group.append(np.full(len(p), k, dtype=np.int32))
        pairs_all = np.concatenate(pair_chunks)
        group_of = np.concatenate(pair_group)
        ci, cj = cnt[pairs_all[:, 0]], cnt[pairs_all[:, 1]]
        hi = np.maximum(ci, cj)
        lo = np.minimum(ci, cj)
        keep = (ci != cj) & (hi >= collapse_ratio * lo)
        flat_pairs = pairs_all[keep]
        group_of = group_of[keep]
        # per-group span bounds in the filtered (still group-ordered) array
        flat_bounds = np.searchsorted(group_of, np.arange(len(flat) + 1))
        Lk = max(32, length)
        seg_A = np.zeros((len(flat_pairs), Lk), dtype=np.uint8)
        seg_B = np.zeros_like(seg_A)
        seg_A[:, :length] = mat[flat_pairs[:, 0]]
        seg_B[:, :length] = mat[flat_pairs[:, 1]]

    # --- odd path: per-group preparation (variable lengths / huge groups),
    # reusing the outer loop's normalization so pair indices and the finish
    # step share one tag ordering ---
    odd_rows: List[Tuple[int, np.ndarray, np.ndarray, int]] = []
    for gi in odd:
        mat_g, pairs_g = _prepare_pairs(norm_list[gi], tag_lists[gi],
                                        max_distance, collapse_ratio)
        if len(pairs_g) == 0:
            results[gi] = {t: t for t in tag_lists[gi]}
        else:
            odd_rows.append((gi, mat_g, pairs_g, mat_g.shape[1]))

    n_flat = len(flat_pairs) if flat_pairs is not None else 0
    total = n_flat + sum(len(p) for _gi, _m, p, _w in odd_rows)
    if total:
        Lk = max([32] + ([length] if n_flat else [])
                 + [w for _gi, _m, _p, w in odd_rows])
        A = np.zeros((total, Lk), dtype=np.uint8)
        B = np.zeros((total, Lk), dtype=np.uint8)
        la = np.empty(total, dtype=np.int32)
        if n_flat:
            A[:n_flat, :seg_A.shape[1]] = seg_A
            B[:n_flat, :seg_B.shape[1]] = seg_B
            la[:n_flat] = length
        pos = n_flat
        odd_spans = []
        for _gi, mat_g, pairs_g, w in odd_rows:
            e = pos + len(pairs_g)
            A[pos:e, :w] = mat_g[pairs_g[:, 0]]
            B[pos:e, :w] = mat_g[pairs_g[:, 1]]
            la[pos:e] = w
            odd_spans.append((pos, e))
            pos = e
        dists = np.asarray(edit_distance_rows(A, B, la, la))
    else:
        dists = np.zeros(0, np.uint8)
        odd_spans = []

    if flat:
        for k, gi in enumerate(flat):
            if results[gi] is not None:
                continue
            s, e = int(flat_bounds[k]), int(flat_bounds[k + 1])
            if s == e:
                results[gi] = {t: t for t in tag_lists[gi]}
            else:
                results[gi] = degenerate_finish(
                    norm_list[gi], tag_lists[gi],
                    flat_pairs[s:e] - int(offs[k]),
                    dists[s:e], max_distance, collapse_ratio)
    for (gi, _mat, pairs_g, _w), (s, e) in zip(odd_rows, odd_spans):
        results[gi] = degenerate_finish(
            norm_list[gi], tag_lists[gi], pairs_g, dists[s:e],
            max_distance, collapse_ratio)
    return results


def correct_degenerate(counts: Dict[bytes, int], max_distance: int,
                       length: int, collapse_ratio: float = 5.0
                       ) -> Dict[bytes, bytes]:
    """Starcode-style ratio clustering (correct_tags.rs:256-332):

    - 0 tags -> {}; 1 tag -> maps (padded) to itself;
    - else: pad tags, find pairs within Levenshtein max_distance, absorb the
      lower-count tag into the higher-count one when the count ratio >=
      collapse_ratio, resolve absorption chains transitively to the root.

    Result keys are the normalized tags; every observed tag maps somewhere
    (unabsorbed tags map to themselves)."""
    if not counts:
        return {}
    norm_counts: Counter = Counter()
    for tag, c in counts.items():
        norm_counts[normalize_tag(tag, length)] += c
    tags = list(norm_counts.keys())
    if len(tags) == 1:
        return {tags[0]: tags[0]}

    max_len = max(len(t) for t in tags)
    padded = [t + b"-" * (max_len - len(t)) for t in tags]

    if len(tags) <= 4096:
        pairs = [(i, j) for i in range(len(tags)) for j in range(i + 1, len(tags))]
    else:
        pairs = candidate_pairs(padded, max_distance)
    # absorption needs differing counts at ratio >= collapse_ratio; drop
    # the rest before computing distances (exact - see degenerate_prepare)
    pairs = [(i, j) for i, j in pairs
             if norm_counts[tags[i]] != norm_counts[tags[j]]
             and (max(norm_counts[tags[i]], norm_counts[tags[j]])
                  >= collapse_ratio
                  * min(norm_counts[tags[i]], norm_counts[tags[j]]))]
    if pairs:
        d = edit_distance_pairs([padded[i] for i, _j in pairs],
                                [padded[j] for _i, j in pairs])
        close_pairs = [(i, j) for (i, j), dd in zip(pairs, d) if dd <= max_distance]
    else:
        close_pairs = []

    neighbors: Dict[int, List[int]] = defaultdict(list)
    for i, j in close_pairs:
        neighbors[i].append(j)
        neighbors[j].append(i)

    # pairwise absorption decisions are independent of whether the absorber
    # is itself absorbed (rust_star builds the full link graph first); a
    # swallowed node takes its highest-count absorber (ties: lexicographic).
    # Chains then resolve transitively to the unabsorbed root
    # (correct_tags.rs:308-328 barcodes_to_resolve walk).
    parent = list(range(len(tags)))

    def better_absorber(a: int, cur: int) -> bool:
        # higher count wins; ties break to the lexicographically smaller tag
        ca, cc = norm_counts[tags[a]], norm_counts[tags[cur]]
        return ca > cc or (ca == cc and tags[a] < tags[cur])

    for i, j in close_pairs:
        ci, cj = norm_counts[tags[i]], norm_counts[tags[j]]
        if ci == cj:
            continue  # equal counts never absorb (bigger swallows smaller)
        a, b = (i, j) if ci > cj else (j, i)
        ca, cb = max(ci, cj), min(ci, cj)
        if ca / cb >= collapse_ratio:
            if parent[b] == b or better_absorber(a, parent[b]):
                parent[b] = a

    def root(i: int) -> int:
        seen = set()
        while parent[i] != i and i not in seen:
            seen.add(i)
            i = parent[i]
        return i

    return {tags[i]: tags[root(i)] for i in range(len(tags))}
