"""Inversion-aware alignment.

Host golden implementation of the reference's inversion machinery
(/root/reference/rust_cmd/src/alignment/alignment_matrix.rs:
inversion_alignment :907-938, perform_inversion_aware_alignment :429-466,
update_inversion_alignment :469-560, convert_inverted_path :838-865):

1. locally align reference vs revcomp(read) (Waterman-Eggert), iteratively
   extracting non-overlapping local alignments >= min_inversion_length via
   path zeroing + re-propagation;
2. map each accepted local alignment's path back into forward-read
   coordinates (convert_inverted_path) and index it by its bounding-box end;
3. run a modified 3-plane global DP over (reference, read) whose match plane
   may "jump" through a stored inversion block for inversion_penalty,
   splicing the reversed block into the traceback with InversionOpen /
   InversionClose CIGAR markers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from clique_tpu.align.cpu import (
    AlignmentResult,
    Matrices,
    clean_and_find_next_best,
    fill_affine,
    simplify_cigar,
    three_way_max,
    traceback,
    DIAG, UP, LEFT,
)
from clique_tpu.align.scoring import AffineScoring, InversionScoring, MAX_NEG_SCORE
from clique_tpu.utils.seq import GAP, reverse_complement, to_bytes


@dataclass
class BoundedAlignment:
    result: AlignmentResult
    bounding_box: Tuple[Tuple[int, int], Tuple[int, int]]


def convert_inverted_path(result: AlignmentResult,
                          total_string_length: int) -> AlignmentResult:
    """Map a revcomp-read local alignment path back to forward-read
    coordinates (alignment_matrix.rs:838-865)."""
    half = total_string_length / 2.0
    new_path = [(x, round(1.0 + half + (half - y))) for x, y in result.path]
    new_path.reverse()
    bounds = ((new_path[-1][0], new_path[0][1]),
              (new_path[0][0], new_path[-1][1]))
    return AlignmentResult(
        reference_name=result.reference_name,
        read_name=result.read_name,
        reference_aligned=result.reference_aligned,
        read_aligned=result.read_aligned,
        read_quals=None,
        cigar=list(result.cigar),
        path=new_path,
        score=result.score,
        reference_start=result.reference_start,
        read_start=result.read_start,
        bounding_box=bounds,
    )


def _fill_inversion_aware(mat: Matrices, inv_map: Dict[Tuple[int, int], BoundedAlignment],
                          s1: bytes, s2: bytes,
                          scoring: InversionScoring) -> Dict[Tuple[int, int, int], BoundedAlignment]:
    """perform_inversion_aware_alignment + update_inversion_alignment
    (alignment_matrix.rs:429-560). Returns the positions where the traceback
    should jump through an inversion: {(x, y, source_plane)} entries are
    encoded in `inv_moves`."""
    n1, n2 = len(s1) + 1, len(s2) + 1
    sc, tb = mat.scores, mat.traceback
    sc[0, 0, 0] = 0.0
    sc[0, 0, 1] = sc[0, 0, 2] = MAX_NEG_SCORE
    for x in range(1, n1):
        sc[x, 0, 0] = MAX_NEG_SCORE
        sc[x, 0, 1] = sc[x, 0, 2] = scoring.gap_open + x * scoring.gap_extend
        tb[x, 0, :] = UP
    for y in range(1, n2):
        sc[0, y, 0] = MAX_NEG_SCORE
        sc[0, y, 1] = sc[0, y, 2] = scoring.gap_open + y * scoring.gap_extend
        tb[0, y, :] = LEFT

    inv_moves: Dict[Tuple[int, int], Tuple[Tuple[int, int], Tuple[int, int], int]] = {}

    for x in range(1, n1):
        for y in range(1, n2):
            ms = scoring.match_mismatch(s1[x - 1], s2[y - 1])
            mm = max(MAX_NEG_SCORE if not mat.is_local else 0.0,
                     sc[x - 1, y - 1, 0] + ms,
                     ms if mat.is_local else MAX_NEG_SCORE)

            # candidate list order matters for ties (Rust max_by keeps last):
            # [inversion, diag(mm), up(plane1), left(plane2)]
            candidates: List[Tuple[float, object]] = []
            inv = inv_map.get((x, y))
            if inv is not None:
                fp = inv.bounding_box[0]
                lp = inv.bounding_box[1]
                assert lp == (x, y)
                inv_best = _max_last([
                    (sc[fp[0] - 1, fp[1] - 1, 1], UP),
                    (sc[fp[0] - 1, fp[1] - 1, 2], LEFT),
                    (sc[fp[0] - 1, fp[1] - 1, 0], DIAG)])
                candidates.append((
                    inv.result.score + inv_best[0] + scoring.inversion_penalty,
                    ("INV", fp, lp, inv_best[1])))
            else:
                candidates.append((MAX_NEG_SCORE, UP))
            candidates.append((mm, DIAG))
            candidates.append((sc[x - 1, y - 1, 1] + ms, UP))
            candidates.append((sc[x - 1, y - 1, 2] + ms, LEFT))

            best_v, best_d = candidates[0]
            for v, d in candidates[1:]:
                if v >= best_v:
                    best_v, best_d = v, d
            sc[x, y, 0] = best_v
            if isinstance(best_d, tuple):
                tb[x, y, 0] = UP  # placeholder; real move in inv_moves
                inv_moves[(x, y)] = (best_d[1], best_d[2], best_d[3])
            else:
                tb[x, y, 0] = best_d
                inv_moves.pop((x, y), None)

            g1 = _max_last([
                (sc[x - 1, y, 1] + scoring.gap_extend, UP),
                (sc[x - 1, y, 2] + scoring.gap_open + scoring.gap_extend, LEFT),
                (sc[x - 1, y, 0] + scoring.gap_open + scoring.gap_extend, DIAG)])
            sc[x, y, 1] = g1[0]
            tb[x, y, 1] = g1[1]
            g2 = _max_last([
                (sc[x, y - 1, 1] + scoring.gap_open + scoring.gap_extend, UP),
                (sc[x, y - 1, 2] + scoring.gap_extend, LEFT),
                (sc[x, y - 1, 0] + scoring.gap_open + scoring.gap_extend, DIAG)])
            sc[x, y, 2] = g2[0]
            tb[x, y, 2] = g2[1]
    return inv_moves


def _max_last(candidates):
    """Rust Iterator::max_by keeps the LAST maximal element."""
    best = candidates[0]
    for c in candidates[1:]:
        if c[0] >= best[0]:
            best = c
    return best


def _traceback_with_inversions(mat: Matrices, inv_map, inv_moves,
                               s1: bytes, s2: bytes, ref_name: str,
                               read_name: str) -> AlignmentResult:
    """perform_3d_global_traceback's inversion branch
    (alignment_matrix.rs:990-1016)."""
    from clique_tpu.align.cpu import find_max_3d

    sc, tb = mat.scores, mat.traceback
    x, y = len(s1), len(s2)
    if mat.is_local:
        mx = find_max_3d(sc, len(s1) + 1, len(s2) + 1)
        x, y = mx[0], mx[1]
    z = 0
    best = sc[x, y, 0]
    for zz in (1, 2):
        if sc[x, y, zz] >= best:
            best = sc[x, y, zz]
            z = zz
    score = float(sc[x, y, z])

    aln1 = bytearray()
    aln2 = bytearray()
    cigars: List[Tuple[int, str]] = []
    path: List[Tuple[int, int]] = []

    while x > 0 and y > 0 and (not mat.is_local or sc[x, y, z] != 0.0):
        sc[x, y, :] = 0.0
        path.append((x, y))
        if z == 0 and (x, y) in inv_moves:
            fp, lp, jump = inv_moves[(x, y)]
            inv = inv_map[(x, y)]
            for p in inv.result.path:
                path.append(p)
            aln1.extend(inv.result.reference_aligned[::-1])
            aln2.extend(inv.result.read_aligned[::-1])
            cigars.append((1, ">"))
            cigars.extend(reversed(inv.result.cigar))
            cigars.append((1, "<"))
            x = fp[0] - 1
            y = fp[1] - 1
            z = {DIAG: 0, UP: 1, LEFT: 2}[jump]
            continue
        direction = int(tb[x, y, z])
        if z == 0:
            cigars.append((1, "M"))
            aln1.append(s1[x - 1])
            aln2.append(s2[y - 1])
            x -= 1
            y -= 1
        elif z == 1:
            cigars.append((1, "D"))
            aln1.append(s1[x - 1])
            aln2.append(GAP)
            x -= 1
        else:
            cigars.append((1, "I"))
            aln1.append(GAP)
            aln2.append(s2[y - 1])
            y -= 1
        z = direction

    while x > 0 and not mat.is_local:
        aln1.append(s1[x - 1])
        aln2.append(GAP)
        x -= 1
        cigars.append((1, "D"))
    while y > 0 and not mat.is_local:
        aln1.append(GAP)
        aln2.append(s2[y - 1])
        y -= 1
        cigars.append((1, "I"))

    aln1.reverse()
    aln2.reverse()
    path.reverse()
    cigars.reverse()
    # reverse the inversion-block cigars back to forward order: the block
    # was pushed as Close, ops..., Open and global reversal flips it
    return AlignmentResult(
        reference_name=ref_name,
        read_name=read_name,
        reference_aligned=bytes(aln1),
        read_aligned=bytes(aln2),
        read_quals=None,
        cigar=simplify_cigar(cigars),
        path=path,
        score=score,
        reference_start=0,
        read_start=0,
    )


def inversion_alignment_batch(reference, reads: List[bytes],
                              reference_name: str, read_names: List[str],
                              inv_scoring: InversionScoring,
                              aff_scoring: AffineScoring
                              ) -> List[AlignmentResult]:
    """Batched inversion-aware alignment (global mode) - the device fast path
    for `--find-inversions`-class workloads (VERDICT r1 item 6).

    Phase 1 SCREENS the whole batch on device: one batched Waterman-Eggert
    local alignment of reference vs revcomp(read) (align/batch.py local
    mode). The reference engine stops hunting inversion blocks the moment
    a local alignment's path drops below min_inversion_length
    (alignment_matrix.rs:920-934 loop; inversion_alignment above), so a
    read whose BEST local hit is already shorter than min_inversion_length
    provably has no inversion blocks - its inversion-aware DP degenerates
    to a plain global fill with InversionScoring and the keep-last tie
    order, which phase 2 runs as one batched device fill
    (tie_order="last"). Only screen-positive reads (rare in real data)
    fall through to the exact host machinery with path zeroing and
    secondary extraction."""
    import jax.numpy as jnp

    from clique_tpu.align import batch as dbatch

    s1 = to_bytes(reference)
    reads_b = [to_bytes(r) for r in reads]
    B = len(reads_b)
    if B == 0:
        return []
    rc_reads = [reverse_complement(r) for r in reads_b]

    L1 = len(s1)
    L2 = max(len(r) for r in reads_b)
    refs_arr = np.tile(np.frombuffer(s1, dtype=np.uint8), (B, 1))
    reads_arr = np.zeros((B, L2), dtype=np.uint8)
    read_lens = np.zeros(B, dtype=np.int32)
    for i, r in enumerate(rc_reads):
        reads_arr[i, :len(r)] = np.frombuffer(r, dtype=np.uint8)
        read_lens[i] = len(r)
    ref_lens = np.full(B, L1, dtype=np.int32)
    bw = np.maximum(ref_lens, read_lens)
    params = dbatch.scoring_to_params(aff_scoring)

    loc, _ = dbatch.align_batch_device(
        refs_arr, reads_arr, ref_lens, read_lens, bw, params,
        n1=L1 + 1, n2=L2 + 1, local=True, return_traceback=False)
    n_ops = np.asarray(loc.n_ops)
    screen_positive = n_ops >= inv_scoring.min_inversion_length

    results: List[Optional[AlignmentResult]] = [None] * B

    # phase 2: batched inversion-aware global fill for screen-negative
    # reads (no hits -> plain keep-last global DP, InversionScoring)
    negatives = [i for i in range(B) if not screen_positive[i]]
    if negatives:
        inv_params = np.array(
            [inv_scoring.match_score, inv_scoring.mismatch_score, 0.0,
             inv_scoring.gap_open, inv_scoring.gap_extend, 1.0],
            dtype=np.float32)
        fwd_arr = np.zeros((len(negatives), L2), dtype=np.uint8)
        fl = np.zeros(len(negatives), dtype=np.int32)
        for j, i in enumerate(negatives):
            fwd_arr[j, :len(reads_b[i])] = np.frombuffer(
                reads_b[i], dtype=np.uint8)
            fl[j] = len(reads_b[i])
        frl = np.full(len(negatives), L1, dtype=np.int32)
        res, _ = dbatch.align_batch_device(
            refs_arr[:len(negatives)], fwd_arr, frl, fl,
            np.maximum(frl, fl), jnp.asarray(inv_params),
            n1=L1 + 1, n2=L2 + 1, special_mode="none", tie_order="last",
            return_traceback=False)
        ops_np = np.asarray(res.ops)
        n_np = np.asarray(res.n_ops)
        scores = np.asarray(res.score)
        for j, i in enumerate(negatives):
            a1, a2, cigar = dbatch.ops_to_alignment(
                ops_np[j], int(n_np[j]), s1, reads_b[i])
            results[i] = AlignmentResult(
                reference_name=reference_name,
                read_name=read_names[i],
                reference_aligned=a1,
                read_aligned=a2,
                read_quals=None,
                cigar=cigar,
                path=[],
                score=float(scores[j]),
            )

    # phase 3: exact host machinery for screen positives
    for i in range(B):
        if screen_positive[i]:
            results[i] = inversion_alignment(
                s1, reads_b[i], reference_name, read_names[i],
                inv_scoring, aff_scoring, local=False)
    return results


def inversion_alignment(reference, read, reference_name: str, read_name: str,
                        inv_scoring: InversionScoring,
                        aff_scoring: AffineScoring,
                        local: bool) -> AlignmentResult:
    """alignment_matrix.rs:907-938."""
    s1 = to_bytes(reference)
    s2 = to_bytes(read)
    mat = Matrices.create(len(s1) + 1, len(s2) + 1, local)
    inv_mat = Matrices.create(len(s1) + 1, len(s2) + 1, True)

    hits: Dict[Tuple[int, int], BoundedAlignment] = {}
    rc_read = reverse_complement(s2)
    fill_affine(inv_mat, s1, rc_read, aff_scoring)
    aligned = traceback(inv_mat, s1, rc_read, reference_name, read_name)

    while aligned is not None:
        if len(aligned.path) > 1:
            converted = convert_inverted_path(aligned, len(s2))
            bounds = converted.bounding_box
            true_pos = bounds[1]
            if len(aligned.path) >= inv_scoring.min_inversion_length:
                clean_and_find_next_best(inv_mat, s1, rc_read, aff_scoring,
                                         aligned)
                hits[true_pos] = BoundedAlignment(converted, bounds)
                aligned = traceback(inv_mat, s1, rc_read, reference_name,
                                    read_name)
            else:
                aligned = None
        else:
            aligned = None

    inv_moves = _fill_inversion_aware(mat, hits, s1, s2, inv_scoring)
    return _traceback_with_inversions(mat, hits, inv_moves, s1, s2,
                                      reference_name, read_name)
