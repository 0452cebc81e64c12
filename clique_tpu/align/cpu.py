"""Exact-semantics host aligner (the behavioral golden model).

This is a line-faithful re-derivation of the reference engine's 3-plane
affine-gap DP (/root/reference/rust_cmd/src/alignment/alignment_matrix.rs:
perform_affine_alignment_bandwidth :376-425, update_3d_score :618-665,
update_3d_score_local :563-615, three_way_max_and_direction :671-683,
perform_3d_global_traceback :941-1086, find_max_value_3d_array :868-899,
clean_and_find_next_best_match_3d :334-362).

It is deliberately written as a plain, obviously-correct python loop: it is
the oracle the batched device kernels (align/batch.py, and through its
bit-identical scan the CUDA fill) are property-tested against, cell for
cell and traceback step for traceback step. Do not optimize it at the
expense of clarity.

Semantics pinned here (the quirks are part of the contract):
- 3 planes: 0 = match/mismatch, 1 = deletion (gap in read, consumes ref),
  2 = insertion (gap in ref, consumes read).
- tie-breaking: "up" (plane-1 source) wins only on strict >, then "left"
  (plane-2 source) on strict >, else "diag" (plane-0 source): diag wins ties.
- terminal-gap discounting: in the last row/column, gap costs are scaled by
  final_gap_multiplier; the *local* update variant skips the multiplier on
  the gap-extend continuation terms (reference :589-607) - reproduced as-is.
- banded fill: band center follows the length-proportional diagonal;
  out-of-band interior cells keep their initial value (0.0 for a fresh
  matrix) - reproduced as-is (fresh-matrix semantics).
- Waterman-Eggert local mode: argmax start with tie rules (smaller x+y, then
  smaller x), path zeroing during traceback so secondary local alignments
  can be extracted after clean_and_find_next_best().
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from clique_tpu.align.scoring import AffineScoring, MAX_NEG_SCORE
from clique_tpu.utils.seq import GAP, to_array, to_bytes

# traceback direction codes == source plane of the move
DIAG, UP, LEFT = 0, 1, 2
# plane indices
PLANE_M, PLANE_DEL, PLANE_INS = 0, 1, 2


def three_way_max(up_value: float, left_value: float, diag_value: float) -> Tuple[float, int]:
    """Value + source-plane direction with the reference's exact tie order
    (alignment_matrix.rs:671-683): up on strict >, then left on strict >,
    else diag."""
    if up_value > left_value:
        if up_value > diag_value:
            return up_value, UP
        return diag_value, DIAG
    elif left_value > diag_value:
        return left_value, LEFT
    return diag_value, DIAG


@dataclass
class Matrices:
    """Fresh DP state: scores[n1, n2, 3] f64 and traceback dirs uint8."""

    scores: np.ndarray
    traceback: np.ndarray
    is_local: bool

    @staticmethod
    def create(n1: int, n2: int, local: bool) -> "Matrices":
        return Matrices(
            scores=np.zeros((n1, n2, 3), dtype=np.float64),
            traceback=np.full((n1, n2, 3), UP, dtype=np.uint8),  # zero == Up(0)
            is_local=local,
        )


@dataclass
class AlignmentResult:
    """Mirror of the reference AlignmentResult (alignment_matrix.rs:693-706)."""

    reference_name: str
    read_name: str
    reference_aligned: bytes
    read_aligned: bytes
    read_quals: Optional[bytes]
    cigar: List[Tuple[int, str]]  # [(count, op)] with ops M/D/I/S/H/</>
    path: List[Tuple[int, int]]
    score: float
    reference_start: int = 0
    read_start: int = 0
    bounding_box: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None

    @property
    def cigar_string(self) -> str:
        return "".join(f"{c}{op}" if op not in "<>" else op for c, op in self.cigar)


def simplify_cigar(ops: List[Tuple[int, str]]) -> List[Tuple[int, str]]:
    """Run-length merge of adjacent same-op elements
    (alignment_functions.rs:874-911)."""
    out: List[Tuple[int, str]] = []
    for count, op in ops:
        if out and out[-1][1] == op and op not in "<>":
            out[-1] = (out[-1][0] + count, op)
        elif out and out[-1][1] == op and op == "<":
            raise ValueError("Cannot have two inversion open tags in a row")
        elif out and out[-1][1] == op and op == ">":
            raise ValueError("Cannot have two inversion closed tags in a row")
        else:
            out.append((count, op))
    return out


def pair_to_cigar(reference_aligned: bytes, read_aligned: bytes
                  ) -> List[Tuple[int, str]]:
    """CIGAR from a gapped (reference, read) column pair: gap in the
    reference -> I, gap in the read -> D, else M; run-length merged
    (reference_read_to_cigar_string, consensus_builders.rs:310-336)."""
    ops = []
    for r, d in zip(reference_aligned, read_aligned):
        if r == GAP:
            ops.append((1, "I"))
        elif d == GAP:
            ops.append((1, "D"))
        else:
            ops.append((1, "M"))
    return simplify_cigar(ops)


def _update_cell_global(sc, tb, s1, s2, scoring, x, y):
    """update_3d_score (alignment_matrix.rs:618-665). Returns per-plane
    changed flags."""
    gm = scoring.final_gap_multiplier if (x == len(s1) or y == len(s2)) else 1.0
    x1 = scoring.gap_open + scoring.gap_extend * gm
    lge = scoring.gap_extend * gm

    ms = scoring.match_mismatch(s1[x - 1], s2[y - 1])
    bm, bd = three_way_max(sc[x - 1, y - 1, 1] + ms, sc[x - 1, y - 1, 2] + ms,
                           sc[x - 1, y - 1, 0] + ms)
    ux = sc[x, y, 0] != bm
    sc[x, y, 0] = bm
    tb[x, y, 0] = bd

    bg, gd = three_way_max(sc[x - 1, y, 1] + lge, sc[x - 1, y, 2] + x1,
                           sc[x - 1, y, 0] + x1)
    uy = sc[x, y, 1] != bg
    sc[x, y, 1] = bg
    tb[x, y, 1] = gd

    bi, idir = three_way_max(sc[x, y - 1, 1] + x1, sc[x, y - 1, 2] + lge,
                             sc[x, y - 1, 0] + x1)
    uz = sc[x, y, 2] != bi
    sc[x, y, 2] = bi
    tb[x, y, 2] = idir
    return ux, uy, uz


def _update_cell_local(sc, tb, s1, s2, scoring, x, y):
    """update_3d_score_local (alignment_matrix.rs:563-615). Note: the
    gap-extend continuation terms deliberately do NOT apply the terminal gap
    multiplier (reference quirk, :589-607)."""
    gm = scoring.final_gap_multiplier if (x == len(s1) or y == len(s2)) else 1.0
    x1 = scoring.gap_open + scoring.gap_extend * gm

    ms = scoring.match_mismatch(s1[x - 1], s2[y - 1])
    mm, _ = three_way_max(0.0, sc[x - 1, y - 1, 0] + ms, ms)
    bm, bd = three_way_max(sc[x - 1, y - 1, 1] + ms, sc[x - 1, y - 1, 2] + ms, mm)
    ux = sc[x, y, 0] != bm
    sc[x, y, 0] = bm
    tb[x, y, 0] = bd

    bg, gd = three_way_max(sc[x - 1, y, 1] + scoring.gap_extend,
                           sc[x - 1, y, 2] + x1, sc[x - 1, y, 0] + x1)
    uy = sc[x, y, 1] != bg
    sc[x, y, 1] = bg
    tb[x, y, 1] = gd

    bi, idir = three_way_max(sc[x, y - 1, 1] + x1,
                             sc[x, y - 1, 2] + scoring.gap_extend,
                             sc[x, y - 1, 0] + x1)
    uz = sc[x, y, 2] != bi
    sc[x, y, 2] = bi
    tb[x, y, 2] = idir
    return ux, uy, uz


def fill_affine(mat: Matrices, seq1, seq2, scoring: AffineScoring,
                bandwidth: Optional[int] = None) -> None:
    """perform_affine_alignment[_bandwidth] (alignment_matrix.rs:366-425).

    seq1 = reference (rows/x), seq2 = read (cols/y). bandwidth=None means the
    full band max(len1, len2)."""
    s1 = to_array(seq1)
    s2 = to_array(seq2)
    n1, n2 = len(s1) + 1, len(s2) + 1
    assert mat.scores.shape[0] >= n1 and mat.scores.shape[1] >= n2
    bw = max(len(s1), len(s2)) if bandwidth is None else bandwidth

    sc, tb = mat.scores, mat.traceback
    sc[0, 0, 0] = 0.0
    sc[0, 0, 1] = MAX_NEG_SCORE
    sc[0, 0, 2] = MAX_NEG_SCORE

    fgm = scoring.final_gap_multiplier
    for x in range(1, n1):
        sc[x, 0, 0] = MAX_NEG_SCORE
        sc[x, 0, 1] = sc[x, 0, 2] = (scoring.gap_open + x * scoring.gap_extend) * fgm
        tb[x, 0, :] = UP
    for y in range(1, n2):
        sc[0, y, 0] = MAX_NEG_SCORE
        sc[0, y, 1] = sc[0, y, 2] = (scoring.gap_open + y * scoring.gap_extend) * fgm
        tb[0, y, :] = LEFT

    update = _update_cell_local if mat.is_local else _update_cell_global
    for x in range(1, n1):
        # band center follows the length-proportional diagonal (:414-417)
        c = int((x / n1) * n2)
        lo = max(1, c - bw)
        hi = min(n2, c + bw)
        for y in range(lo, hi):
            update(sc, tb, s1, s2, scoring, x, y)


def find_max_3d(scores: np.ndarray, n1: int, n2: int) -> Optional[Tuple[int, int, float]]:
    """Waterman-Eggert argmax with tie rules: strictly greater wins; on equal
    value prefer smaller x+y, then smaller x (alignment_matrix.rs:868-899).
    Scans the [0:n1, 0:n2] window."""
    best = (0, 0, 0, MAX_NEG_SCORE)
    for x in range(n1):
        for y in range(n2):
            for z in range(3):
                v = scores[x, y, z]
                bx, by, _bz, bv = best
                if v > bv or (v == bv and (x + y) < (bx + by)) or \
                        (v == bv and (x + y) == (bx + by) and x < bx):
                    best = (x, y, z, v)
    if best[3] > MAX_NEG_SCORE:
        return best[0], best[1], best[3]
    return None


def traceback(mat: Matrices, seq1, seq2, seq1_name: str = "ref",
              seq2_name: str = "read", read_quality: Optional[bytes] = None,
              starting_position: Optional[Tuple[int, int]] = None) -> AlignmentResult:
    """perform_3d_global_traceback (alignment_matrix.rs:941-1086).

    Zeroes the walked path (all 3 planes) so secondary local alignments can
    be extracted afterwards."""
    s1 = to_array(seq1)
    s2 = to_array(seq2)
    sc, tb = mat.scores, mat.traceback

    x, y = len(s1), len(s2)
    if starting_position is not None:
        x, y = starting_position
    elif mat.is_local:
        mx = find_max_3d(sc, len(s1) + 1, len(s2) + 1)
        x, y = mx[0], mx[1]

    # starting plane: max score; later planes win ties (Rust max_by keeps last)
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
        direction = int(tb[x, y, z])
        if z == PLANE_M:
            cigars.append((1, "M"))
            aln1.append(s1[x - 1])
            aln2.append(s2[y - 1])
            x -= 1
            y -= 1
        elif z == PLANE_DEL:
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

    if not mat.is_local:
        while x > 0:
            aln1.append(s1[x - 1])
            aln2.append(GAP)
            x -= 1
            cigars.append((1, "D"))
        while y > 0:
            aln1.append(GAP)
            aln2.append(s2[y - 1])
            y -= 1
            cigars.append((1, "I"))

    aln1.reverse()
    aln2.reverse()
    path.reverse()
    cigars.reverse()

    return AlignmentResult(
        reference_name=seq1_name,
        read_name=seq2_name,
        reference_aligned=bytes(aln1),
        read_aligned=bytes(aln2),
        read_quals=read_quality,
        cigar=simplify_cigar(cigars),
        path=path,
        score=score,
        reference_start=0,
        read_start=0,
    )


def _update_sub_vector(mat: Matrices, s1, s2, scoring, row, col, by_row) -> int:
    """update_sub_vector3d (alignment_matrix.rs:269-299): re-propagate scores
    down a row/column after path zeroing, stopping at the first cell whose
    three planes all keep their value. Always uses the local update rule."""
    row_pos = row + 1 if by_row else row
    col_pos = col if by_row else col + 1
    count = 0
    while row_pos < mat.scores.shape[0] and col_pos < mat.scores.shape[1]:
        ux, uy, uz = _update_cell_local(mat.scores, mat.traceback, s1, s2,
                                        scoring, row_pos, col_pos)
        if ux or uy or uz:
            if by_row:
                row_pos += 1
            else:
                col_pos += 1
            count += 1
        else:
            break
    return count


def clean_and_find_next_best(mat: Matrices, seq1, seq2, scoring: AffineScoring,
                             previous: AlignmentResult) -> None:
    """clean_and_find_next_best_match_3d (alignment_matrix.rs:334-362):
    after a traceback zeroed its path, re-propagate so the next-best
    (Waterman-Eggert secondary) alignment can be traced."""
    s1 = to_array(seq1)
    s2 = to_array(seq2)
    cur_row = cur_col = 0
    for (px, py) in previous.path:
        cur_row, cur_col = px, py
        for _ in range(3):
            _update_sub_vector(mat, s1, s2, scoring, cur_row, cur_col, True)
            _update_sub_vector(mat, s1, s2, scoring, cur_row, cur_col, False)

    rows = cols = True
    while (rows or cols) and cur_row < mat.scores.shape[0] and cur_col < mat.scores.shape[1]:
        rows = _update_sub_vector(mat, s1, s2, scoring, cur_row, cur_col, True) > 0
        cols = _update_sub_vector(mat, s1, s2, scoring, cur_row, cur_col, False) > 0
        cur_row += 1
        cur_col += 1


def affine_align(seq1, seq2, scoring: AffineScoring, local: bool = False,
                 bandwidth: Optional[int] = None, seq1_name: str = "ref",
                 seq2_name: str = "read",
                 read_quality: Optional[bytes] = None) -> AlignmentResult:
    """align_two_strings (alignment_manager.rs:231-273): fresh matrices, fill,
    global/local traceback."""
    s1 = to_bytes(seq1)
    s2 = to_bytes(seq2)
    mat = Matrices.create(len(s1) + 1, len(s2) + 1, local)
    fill_affine(mat, s1, s2, scoring, bandwidth)
    return traceback(mat, s1, s2, seq1_name, seq2_name, read_quality)


def affine_align_fast(seq1, seq2, scoring: AffineScoring,
                      seq1_name: str = "ref", seq2_name: str = "read",
                      read_quality: Optional[bytes] = None
                      ) -> AlignmentResult:
    """Vectorized (numpy, jax-free) global affine_align: identical output
    to affine_align(local=False, full band) - the anti-diagonal fill of
    align/batch.py in f64 numpy, for host paths that cannot touch the
    device (the soft-clip Realign recovery inside jax-free collapse
    workers, extractor.rs:143-171). Property-tested against the golden in
    tests/test_align_cpu.py."""
    s1 = to_bytes(seq1)
    s2 = to_bytes(seq2)
    a1 = np.frombuffer(s1, dtype=np.uint8).astype(np.int32)
    a2 = np.frombuffer(s2, dtype=np.uint8).astype(np.int32)
    n1, n2 = len(s1) + 1, len(s2) + 1
    D = n1 + n2 - 1
    neg = MAX_NEG_SCORE
    fgm = scoring.final_gap_multiplier
    go, ge = scoring.gap_open, scoring.gap_extend
    m_s, mm_s, sp_s = (scoring.match_score, scoring.mismatch_score,
                       scoring.special_character_score)

    xs = np.arange(n1, dtype=np.int64)
    rx = np.concatenate(([0], a1))                       # ref byte per lane
    special_x = (rx == 78) | ((rx < 58) & (rx > 0))

    def three_way(up, left, diag):
        up_wins = (up > left) & (up > diag)
        left_wins = ~(up > left) & (left > diag)
        val = np.where(up_wins, up, np.where(left_wins, left, diag))
        d = np.where(up_wins, UP, np.where(left_wins, LEFT, DIAG))
        return val, d.astype(np.uint8)

    zeros = np.zeros(n1)
    pm = pp1 = pp2 = zeros
    p2m = p2p1 = p2p2 = zeros
    tb = np.zeros((D, n1, 3), dtype=np.uint8)
    corner = np.zeros(3)
    win = np.zeros(n1, dtype=np.int32)

    for d in range(D):
        y = d - xs
        # rolling read-byte window (systolic): lane x holds read[d-1-x]
        new_byte = a2[min(max(d - 1, 0), n2 - 2)] if n2 > 1 else 0
        win = np.concatenate(([new_byte], win[:-1]))
        ry = win
        special = special_x | (ry == 78) | ((ry < 58) & (ry > 0))
        ms = np.where(special, sp_s,
                      np.where(rx == ry, m_s, mm_s))

        gm = np.where((xs == n1 - 1) | (y == n2 - 1), fgm, 1.0)
        x1 = go + ge * gm
        lge = ge * gm

        def sh(v):
            return np.concatenate(([0.0], v[:-1]))

        m_val, m_dir = three_way(sh(p2p1) + ms, sh(p2p2) + ms,
                                 sh(p2m) + ms)
        d_val, d_dir = three_way(sh(pp1) + lge, sh(pp2) + x1, sh(pm) + x1)
        i_val, i_dir = three_way(pp1 + x1, pp2 + lge, pm + x1)

        interior = (xs >= 1) & (y >= 1) & (y < n2)
        is_x_border = (xs == 0) & (y >= 1) & (y < n2)
        is_y_border = (y == 0) & (xs >= 1)
        is_origin = (xs == 0) & (y == 0)
        xb = (go + y * ge) * fgm
        yb = (go + xs * ge) * fgm
        m_out = np.where(interior, m_val,
                         np.where(is_origin, 0.0,
                                  np.where(is_x_border | is_y_border,
                                           neg, 0.0)))
        p1_out = np.where(interior, d_val,
                          np.where(is_x_border, xb,
                                   np.where(is_y_border, yb,
                                            np.where(is_origin, neg, 0.0))))
        p2_out = np.where(interior, i_val,
                          np.where(is_x_border, xb,
                                   np.where(is_y_border, yb,
                                            np.where(is_origin, neg, 0.0))))
        tb[d, :, 0] = np.where(interior, m_dir, UP)
        tb[d, :, 1] = np.where(interior, d_dir, UP)
        tb[d, :, 2] = np.where(interior, i_dir, UP)
        if d == n1 - 1 + n2 - 1:
            corner[:] = (m_out[n1 - 1], p1_out[n1 - 1], p2_out[n1 - 1])
        p2m, p2p1, p2p2 = pm, pp1, pp2
        pm, pp1, pp2 = m_out, p1_out, p2_out

    # starting plane: last max wins (Rust max_by)
    z = 0
    best = corner[0]
    for zz in (1, 2):
        if corner[zz] >= best:
            best = corner[zz]
            z = zz
    score = float(best)

    x, y = n1 - 1, n2 - 1
    aln1 = bytearray()
    aln2 = bytearray()
    cigars: List[Tuple[int, str]] = []
    path: List[Tuple[int, int]] = []
    while x > 0 and y > 0:
        path.append((x, y))
        direction = int(tb[x + y, x, z])
        if z == PLANE_M:
            cigars.append((1, "M"))
            aln1.append(s1[x - 1])
            aln2.append(s2[y - 1])
            x -= 1
            y -= 1
        elif z == PLANE_DEL:
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
    while x > 0:
        aln1.append(s1[x - 1])
        aln2.append(GAP)
        x -= 1
        cigars.append((1, "D"))
    while y > 0:
        aln1.append(GAP)
        aln2.append(s2[y - 1])
        y -= 1
        cigars.append((1, "I"))
    aln1.reverse()
    aln2.reverse()
    path.reverse()
    cigars.reverse()
    return AlignmentResult(
        reference_name=seq1_name, read_name=seq2_name,
        reference_aligned=bytes(aln1), read_aligned=bytes(aln2),
        read_quals=read_quality, cigar=simplify_cigar(cigars), path=path,
        score=score, reference_start=0, read_start=0)
