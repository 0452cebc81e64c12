"""Batched 3-plane affine-gap DP on device (jax / XLA).

Batched reformulation of the reference engine's per-read DP
(/root/reference/rust_cmd/src/alignment/alignment_matrix.rs:366-683): instead
of one f64 matrix per thread, a whole length-bucketed batch of reads is
aligned at once by sweeping anti-diagonals of the (ref x read) rectangle.
Each anti-diagonal is a fully data-parallel [B, X] vector op; the
sequential dimension is a single `lax.scan` over diagonals, so XLA compiles
the entire fill into one fused loop with no host round-trips.

Cell (x, y) on diagonal d = x + y depends only on diagonals d-1 (gap planes)
and d-2 (match plane), so the scan carries two diagonal slabs per plane.
Traceback directions are packed 2 bits/plane into one uint8 per cell and
streamed out diagonal-major; the traceback walk itself also runs on device
as a vmapped scan (one gather per step), emitting a per-step op code that
the host expands into aligned strings + CIGAR.

Exactness: float32 is bit-decision-identical to the host f64 golden model
(align/cpu.py) because all scoring constants are dyadic rationals and every
intermediate is a sum of < 2^18-magnitude dyadics -- exactly representable
in f32. Property tests in tests/test_align_batch.py pin this cell-for-cell.

Semantics reproduced exactly (global mode):
- tie order up(plane1) > left(plane2) > diag(plane0), diag wins ties;
- terminal-gap multiplier on last row/column (per-element true lengths);
- banded fill with length-proportional band center; out-of-band cells keep
  fresh-matrix values (0.0 scores / "up" traceback);
- traceback from the per-element (len1, len2) corner, starting plane =
  argmax with later planes winning ties, then trailing D/I runs.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from clique_tpu.align.scoring import AffineScoring, MAX_NEG_SCORE

# direction codes (== source plane), same as align/cpu.py
DIAG, UP, LEFT = 0, 1, 2
# a packed traceback byte with all three planes set to UP (fresh-matrix value)
_TB_FRESH = UP | (UP << 2) | (UP << 4)

# op codes emitted by the traceback walk
OP_MATCH, OP_DEL, OP_INS, OP_DONE = 0, 1, 2, 3


class BatchAlignment(NamedTuple):
    """Device-side result of a batched fill + traceback."""

    score: jax.Array      # [B] f32 alignment score
    start_z: jax.Array    # [B] i32 starting plane (diagnostic)
    ops: jax.Array        # [B, T] uint8 op codes (OP_* above), OP_DONE-padded
    n_ops: jax.Array      # [B] i32 number of valid ops
    ops_packed: jax.Array  # [B, ceil(T/4)] uint8, 4 ops per byte - pull
    #                        this instead of `ops` on slow transfer links


class LocalBatchAlignment(NamedTuple):
    """Waterman-Eggert local alignment batch result: ops cover only the
    local segment; (ref_start, read_start) .. (ref_end, read_end) are the
    matrix coordinates of the walked path (start = where the walk stopped,
    end = the 3D argmax cell, alignment_matrix.rs:868-899)."""

    score: jax.Array       # [B] f32
    start_z: jax.Array     # [B] i32 starting plane at the argmax cell
    ops: jax.Array         # [B, T] uint8
    n_ops: jax.Array       # [B] i32
    ops_packed: jax.Array  # [B, ceil(T/4)] uint8
    ref_start: jax.Array   # [B] i32
    read_start: jax.Array  # [B] i32
    ref_end: jax.Array     # [B] i32
    read_end: jax.Array    # [B] i32


def _three_way_max(up, left, diag):
    """Vectorized three_way_max_and_direction (alignment_matrix.rs:671-683):
    up on strict >, then left on strict >, else diag (ties -> diag)."""
    up_wins = (up > left) & (up > diag)
    left_wins = jnp.logical_not(up > left) & (left > diag)
    val = jnp.where(up_wins, up, jnp.where(left_wins, left, diag))
    direction = jnp.where(up_wins, UP, jnp.where(left_wins, LEFT, DIAG)).astype(jnp.uint8)
    return val, direction


def _max_last3(up, left, diag, dir_up, dir_left, dir_diag):
    """Rust `Iterator::max_by` keep-LAST semantics over an ordered candidate
    list [up, left, diag]: diag wins ties against everything, left against
    up (the inversion-aware fill's tie order, alignment_matrix.rs:469-560
    via inversion.py _max_last)."""
    val = jnp.maximum(jnp.maximum(up, left), diag)
    direction = jnp.where(
        diag >= jnp.maximum(up, left), dir_diag,
        jnp.where(left >= up, dir_left, dir_up)).astype(jnp.uint8)
    return val, direction


def _shift_down(arr):
    """[B, X] -> value at index x-1 (x axis), zero-filled at x=0."""
    return jnp.pad(arr[:, :-1], ((0, 0), (1, 0)))


def select_fill(backend: str, *, n1: int, batch: int, banded: bool = False,
                local: bool = False, mesh_size: int = 1) -> str:
    """The fill one dispatch runs: the CUDA kernel (align/dp_fill.cu) on a
    GPU for global full-band fills it can shape - at most MAX_ROWS DP rows,
    a batch that splits evenly over the mesh - and the XLA scan for
    everything else (CPU, banded and local fills)."""
    from clique_tpu.align.cuda_fill import MAX_ROWS

    if backend != "gpu" or banded or local or n1 > MAX_ROWS \
            or batch % mesh_size:
        return "scan"
    return "cuda"


def _shard_fill(fill_fn, mesh, *, shared_ref: bool):
    """Run a (refs, reads, ref_lens, read_lens, params) -> (words, corner)
    fill under shard_map with the batch split over the mesh's "data" axis
    (XLA cannot partition a custom call on its own). A one-row reference
    is replicated; words [Wd, B, n1] shard on their batch axis."""
    from jax.sharding import PartitionSpec as P

    return jax.shard_map(
        fill_fn, mesh=mesh,
        in_specs=(P() if shared_ref else P("data"), P("data"), P("data"),
                  P("data"), P()),
        out_specs=(P(None, "data"), P("data")), check_vma=False)


@functools.partial(jax.jit, static_argnames=("n1", "n2", "local",
                                             "special_mode", "fill",
                                             "return_traceback",
                                             "tie_order", "mesh"))
def align_batch_device(
    refs: jax.Array,
    reads: jax.Array,
    ref_lens: jax.Array,
    read_lens: jax.Array,
    bandwidth: jax.Array,
    scoring_params: jax.Array,
    *,
    n1: int,
    n2: int,
    local: bool = False,
    special_mode: str = "both",
    fill: str = "scan",
    return_traceback: bool = True,
    band_centers: Optional[jax.Array] = None,
    tie_order: str = "ref",
    mesh=None,
):
    """Full device alignment: fill + corner extraction + traceback walk.

    fill="cuda" runs the fill as the CUDA kernel (cuda_fill, bit-identical
    to the scan; global mode, reference tie order, and a bandwidth that
    covers the full rectangle - the caller's responsibility, see
    select_fill); the packed traceback walk is shared. With a data `mesh`
    (static) the kernel runs under shard_map with the batch split over
    "data"; the caller makes B divisible by the mesh size.

    refs may have leading dim 1 with B reads (a uniform-reference batch):
    the reference row broadcasts on device, so single-amplicon pipelines
    ship ~n1 bytes per dispatch instead of B x n1.

    Returns BatchAlignment (ops in forward order) and the batch-major
    traceback bytes [B, D, n1] (for debugging/tests; None when
    return_traceback=False).
    """
    D = n1 + n2 - 1

    if fill == "cuda":
        if local or tie_order != "ref":
            raise ValueError(
                "the CUDA fill covers global mode with the reference tie "
                "order only")
        from clique_tpu.align.cuda_fill import cuda_fill

        fill_fn = functools.partial(cuda_fill, n1=n1, n2=n2,
                                    special_mode=special_mode)
        if mesh is not None:
            fill_fn = _shard_fill(fill_fn, mesh,
                                  shared_ref=refs.shape[0] != reads.shape[0])
        words, corner = fill_fn(refs, reads, ref_lens.astype(jnp.int32),
                                read_lens.astype(jnp.int32), scoring_params)
        res = _finish_from_packed_traceback(
            words, corner, ref_lens, read_lens, n1=n1, n2=n2)
        tb_b = unpack_words(words, D) if return_traceback else None
        return res, tb_b
    if fill != "scan":
        raise ValueError(f"unknown fill {fill!r}")

    if local:
        tb, zflags, best = _scan_fill(
            refs, reads, ref_lens, read_lens, bandwidth, scoring_params,
            n1=n1, n2=n2, local=True, special_mode=special_mode,
            band_centers=band_centers, tie_order=tie_order)
        tb_b = jnp.transpose(tb, (1, 0, 2)) if return_traceback else None
        return _finish_local(tb, zflags, best, n1=n1, n2=n2), tb_b
    tb, corner = _scan_fill(
        refs, reads, ref_lens, read_lens, bandwidth, scoring_params,
        n1=n1, n2=n2, local=False, special_mode=special_mode,
        band_centers=band_centers, tie_order=tie_order)
    # tb: [D, B, n1] -> [B, D, n1] batch-major view for tests/debug
    tb_b = jnp.transpose(tb, (1, 0, 2)) if return_traceback else None
    if os.environ.get("CLIQUE_TPU_PACKED_WALK", "1") == "1":
        # walk 4 diagonals per scan step over packed int32 words (the
        # CUDA fill's output layout; ops bit-identical to the
        # per-diagonal walk). CLIQUE_TPU_PACKED_WALK=0 restores the
        # per-diagonal walk.
        res = _finish_from_packed_traceback(
            pack_words(tb), corner, ref_lens, read_lens, n1=n1, n2=n2)
        return res, tb_b
    return _finish_from_traceback(
        tb, tb_b, corner, ref_lens, read_lens, n1=n1, n2=n2)


@functools.partial(jax.jit, static_argnames=("n1", "n2", "special_mode"))
def scan_fill(refs, reads, ref_lens, read_lens, scoring_params, *,
              n1: int, n2: int, special_mode: str = "both"):
    """The plain XLA reference for cuda_fill, with its signature: the
    global full-band scan fill as (packed words [ceil(D/4), B, n1] int32,
    corner [B, 3] f32)."""
    ref_lens = jnp.asarray(ref_lens, jnp.int32)
    read_lens = jnp.asarray(read_lens, jnp.int32)
    bw = jnp.maximum(jnp.maximum(ref_lens, read_lens), 1)
    tb, corner = _scan_fill(refs, reads, ref_lens, read_lens, bw,
                            scoring_params, n1=n1, n2=n2, local=False,
                            special_mode=special_mode, band_centers=None,
                            tie_order="ref")
    return pack_words(tb), corner


def pack_words(tb):
    """Diagonal-major traceback bytes [D, B, n1] -> int32 words
    [ceil(D/4), B, n1], 4 diagonals per word at shift 8*(d%4); diagonals
    past D pad with the fresh-cell byte."""
    D = tb.shape[0]
    Dp4 = -(-D // 4)
    tb_pad = jnp.pad(tb, ((0, 4 * Dp4 - D), (0, 0), (0, 0)),
                     constant_values=_TB_FRESH).astype(jnp.int32)
    w = tb_pad.reshape(Dp4, 4, *tb.shape[1:])
    return w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16) | (w[:, 3] << 24)


def unpack_words(words, D: int):
    """Inverse of pack_words: [Wd, B, n1] int32 -> batch-major traceback
    bytes [B, D, n1] uint8."""
    Wd, B, n1 = words.shape
    shifts = jnp.arange(4, dtype=jnp.int32) * 8
    u = ((words[:, None] >> shifts[None, :, None, None]) & 0xFF
         ).astype(jnp.uint8)
    return jnp.transpose(u.reshape(4 * Wd, B, n1)[:D], (1, 0, 2))


def _scan_fill(refs, reads, ref_lens, read_lens, bandwidth, scoring_params,
               *, n1: int, n2: int, local: bool, special_mode: str,
               band_centers, tie_order: str):
    """The anti-diagonal lax.scan fill. Returns diagonal-major traceback
    bytes [D, B, n1] and the corner values [B, 3] (global), or the
    traceback, the zero flags and the running argmax (local)."""
    B = reads.shape[0]
    D = n1 + n2 - 1
    f32 = jnp.float32

    m_s, mm_s, sp_s, go, ge, fgm = [scoring_params[i] for i in range(6)]

    xs = jnp.arange(n1, dtype=jnp.int32)
    l1 = ref_lens[:, None].astype(jnp.int32)
    l2 = read_lens[:, None].astype(jnp.int32)
    bw = bandwidth[:, None].astype(jnp.int32)
    refs_i = refs.astype(jnp.int32)
    reads_i = reads.astype(jnp.int32)
    neg = jnp.float32(MAX_NEG_SCORE)

    # per-step gathers are slow inside the scan; instead:
    # rx (ref byte per DP row) is constant across diagonals - hoist it;
    # ry (read byte at y-1 = d-x-1) is a rolling window: shift down one
    # lane per diagonal and insert read[d-1] at lane 0 (systolic layout)
    rx_const = jnp.pad(refs_i[:, :n1 - 1], ((0, 0), (1, 0)))   # [B|1, n1]
    if rx_const.shape[0] != B:
        # uniform-reference batch: broadcast the single row on device
        rx_const = jnp.broadcast_to(rx_const, (B, n1))

    # band centers are constant across diagonals - hoist them. The exact
    # reference formula is f64 truncation int((x/(l1+1))*(l2+1))
    # (alignment_matrix.rs:414), which rounds DOWN one at exact multiples;
    # callers using partial bands must pass band_centers from
    # band_centers_f64() for bit parity. The integer-division fallback
    # only matters for full-band fills, where the band covers everything.
    if band_centers is None:
        centers_const = (xs[None, :] * (l2 + 1)) // jnp.maximum(l1 + 1, 1)
    else:
        centers_const = band_centers.astype(jnp.int32)

    def step(carry, d):
        if local:
            prev, prev2, corner, win, best = carry
        else:
            prev, prev2, corner, win = carry
        pm, pp1, pp2 = prev
        p2m, p2p1, p2p2 = prev2

        y = jnp.broadcast_to(d - xs[None, :], (B, n1))
        x = jnp.broadcast_to(xs[None, :], (B, n1))

        rx = rx_const
        new_byte = jax.lax.dynamic_slice(
            reads_i, (0, jnp.clip(d - 1, 0, n2 - 2)), (B, 1))
        win = jnp.where(xs[None, :] == 0, new_byte,
                        jnp.pad(win[:, :-1], ((0, 0), (1, 0))))
        ry = win
        if special_mode == "ref_n_only":
            # rust-bio-compat rule (alignment_functions.rs:55): only a
            # reference-side N scores as a guaranteed match
            special = rx == 78
        elif special_mode == "none":
            # InversionScoring has no wildcard rule (scoring_functions.rs
            # :133-135)
            special = jnp.zeros_like(rx, bool)
        else:
            special = (rx == 78) | (ry == 78) | (rx < 58) | (ry < 58)
        ms = jnp.where(special, sp_s, jnp.where(rx == ry, m_s, mm_s))

        gm = jnp.where((x == l1) | (y == l2), fgm, f32(1.0))
        x1 = go + ge * gm
        lge = ge * gm

        p2m_s = _shift_down(p2m)
        p2p1_s = _shift_down(p2p1)
        p2p2_s = _shift_down(p2p2)
        pm_s = _shift_down(pm)
        pp1_s = _shift_down(pp1)
        pp2_s = _shift_down(pp2)

        if local:
            mm_val = jnp.maximum(jnp.maximum(f32(0.0), p2m_s + ms), ms)
        else:
            mm_val = p2m_s + ms
        if tie_order == "last":
            # inversion-aware fill semantics (update_inversion_alignment,
            # alignment_matrix.rs:469-560): Rust max_by keeps the LAST
            # maximal candidate; the m-plane's mm term is floored at
            # MAX_NEG_SCORE by the placeholder candidate
            if not local:
                mm_val = jnp.maximum(mm_val, neg)
            m_val, m_dir = _max_last3(
                mm_val, p2p1_s + ms, p2p2_s + ms, DIAG, UP, LEFT)
            d_val, d_dir = _max_last3(
                pp1_s + lge, pp2_s + x1, pm_s + x1, UP, LEFT, DIAG)
            i_val, i_dir = _max_last3(
                pp1 + x1, pp2 + lge, pm + x1, UP, LEFT, DIAG)
        elif local:
            m_val, m_dir = _three_way_max(p2p1_s + ms, p2p2_s + ms, mm_val)
            d_val, d_dir = _three_way_max(pp1_s + ge, pp2_s + x1, pm_s + x1)
            i_val, i_dir = _three_way_max(pp1 + x1, pp2 + ge, pm + x1)
        else:
            m_val, m_dir = _three_way_max(p2p1_s + ms, p2p2_s + ms, mm_val)
            d_val, d_dir = _three_way_max(pp1_s + lge, pp2_s + x1, pm_s + x1)
            i_val, i_dir = _three_way_max(pp1 + x1, pp2 + lge, pm + x1)

        c = centers_const
        lo = jnp.maximum(1, c - bw)
        hi = jnp.minimum(l2 + 1, c + bw)
        interior = (x >= 1) & (x <= l1) & (y >= lo) & (y < hi)
        is_x_border = (x == 0) & (y >= 1) & (y <= l2)
        is_y_border = (y == 0) & (x >= 1) & (x <= l1)
        is_origin = (x == 0) & (y == 0)

        xb = (go + y.astype(f32) * ge) * fgm
        yb = (go + x.astype(f32) * ge) * fgm

        m_out = jnp.where(
            interior, m_val,
            jnp.where(is_origin, f32(0.0),
                      jnp.where(is_x_border | is_y_border, neg, f32(0.0))))
        p1_out = jnp.where(
            interior, d_val,
            jnp.where(is_x_border, xb,
                      jnp.where(is_y_border, yb,
                                jnp.where(is_origin, neg, f32(0.0)))))
        p2_out = jnp.where(
            interior, i_val,
            jnp.where(is_x_border, xb,
                      jnp.where(is_y_border, yb,
                                jnp.where(is_origin, neg, f32(0.0)))))

        tb_byte = jnp.where(
            interior,
            m_dir.astype(jnp.uint8)
            | (d_dir.astype(jnp.uint8) << 2)
            | (i_dir.astype(jnp.uint8) << 4),
            jnp.uint8(_TB_FRESH))

        # capture the (l1, l2) corner when its diagonal comes by; one-hot
        # lane reduction instead of a per-step gather
        on_corner_diag = (l1[:, 0] + l2[:, 0]) == d                 # [B]
        corner_lane = (xs[None, :] == l1)                           # [B, n1]
        corner_col = jnp.stack(
            [jnp.sum(jnp.where(corner_lane, v, 0.0), axis=1)
             for v in (m_out, p1_out, p2_out)], axis=-1)            # [B, 3]
        corner = jnp.where(on_corner_diag[:, None], corner_col, corner)

        if not local:
            return ((m_out, p1_out, p2_out), prev, corner, win), tb_byte

        # --- Waterman-Eggert machinery (local mode only) ------------------
        # per-plane zero flags: the walk stops at value-0.0 cells
        # (perform_3d_global_traceback :955 `scores != 0.0` condition);
        # dyadic scoring makes f32 == 0.0 decision-identical to f64
        z_byte = ((m_out == 0.0).astype(jnp.uint8)
                  | ((p1_out == 0.0).astype(jnp.uint8) << 1)
                  | ((p2_out == 0.0).astype(jnp.uint8) << 2))
        # running 3D argmax with the find_max_value_3d_array tie rules
        # (:868-899): strictly-greater replaces; ties prefer smaller x+y
        # (= earlier diagonal, so never replace on equal) then smaller x
        # (= first maximum within the diagonal, lanes scan x ascending)
        best_val, best_x, best_d, best_col = best
        far_neg = f32(2.0 * MAX_NEG_SCORE)
        validc = (x <= l1) & (y >= 0) & (y <= l2)
        cell = jnp.maximum(m_out, jnp.maximum(p1_out, p2_out))
        cell = jnp.where(validc, cell, far_neg)
        lane_best = jnp.argmax(cell, axis=1).astype(jnp.int32)
        onehot = xs[None, :] == lane_best[:, None]
        dmax = jnp.sum(jnp.where(onehot, cell, 0.0), axis=1)
        dcol = jnp.stack(
            [jnp.sum(jnp.where(onehot, v, 0.0), axis=1)
             for v in (m_out, p1_out, p2_out)], axis=-1)
        replace = dmax > best_val
        best = (jnp.where(replace, dmax, best_val),
                jnp.where(replace, lane_best, best_x),
                jnp.where(replace, d, best_d),
                jnp.where(replace[:, None], dcol, best_col))
        return ((m_out, p1_out, p2_out), prev, corner, win, best), \
            (tb_byte, z_byte)

    zeros = jnp.zeros((B, n1), dtype=f32)
    if local:
        init_best = (jnp.full((B,), 4.0 * MAX_NEG_SCORE, f32),
                     jnp.zeros((B,), jnp.int32),
                     jnp.zeros((B,), jnp.int32),
                     jnp.zeros((B, 3), f32))
        init = ((zeros, zeros, zeros), (zeros, zeros, zeros),
                jnp.zeros((B, 3), dtype=f32),
                jnp.zeros((B, n1), jnp.int32), init_best)
        (_, _, _corner, _win, best), (tb, zflags) = jax.lax.scan(
            step, init, jnp.arange(D, dtype=jnp.int32))
        return tb, zflags, best
    init = ((zeros, zeros, zeros), (zeros, zeros, zeros),
            jnp.zeros((B, 3), dtype=f32), jnp.zeros((B, n1), jnp.int32))
    (_, _, corner, _win), tb = jax.lax.scan(
        step, init, jnp.arange(D, dtype=jnp.int32))
    return tb, corner


def _finish_from_traceback(tb, tb_b, corner, ref_lens, read_lens,
                           *, n1: int, n2: int):
    """Shared epilogue: starting plane + score from the corner, then the
    gather-free traceback walk and 2-bit op packing. tb is diagonal-major
    [D, B, n1]; tb_b the batch-major view returned for tests."""
    B = tb.shape[1]
    D = n1 + n2 - 1
    z0, score = _corner_to_z0_score(corner)

    # --- traceback walk (perform_3d_global_traceback, :941-1086) ----------
    # Gather-free diagonal-major walk: the walk visits strictly decreasing
    # diagonals (z=0 steps skip one), so scanning d = D-1 .. 0 with the
    # traceback array itself as the scan input feeds each diagonal's bytes
    # without any gather; the per-element byte at lane x is a one-hot lane
    # reduction.
    lane = jnp.arange(n1, dtype=jnp.int32)[None, :]

    def walk_step(state, tb_diag):
        x, y, z, d = state
        active = (x + y == d) & ((x > 0) | (y > 0))
        in_core = (x > 0) & (y > 0)
        op = jnp.where(
            active & in_core, z.astype(jnp.uint8),
            jnp.where(active & (x > 0), jnp.uint8(OP_DEL),
                      jnp.where(active & (y > 0), jnp.uint8(OP_INS),
                                jnp.uint8(OP_DONE))))

        byte = jnp.sum(
            jnp.where(lane == x[:, None], tb_diag.astype(jnp.int32), 0),
            axis=1)
        direction = (byte >> (2 * z)) & 3

        step_core = active & in_core
        dx = jnp.where(step_core, jnp.where(z == 2, 0, 1),
                       jnp.where(active & (x > 0), 1, 0))
        dy = jnp.where(step_core, jnp.where(z == 1, 0, 1),
                       jnp.where(active & (x <= 0) & (y > 0), 1, 0))
        new_z = jnp.where(step_core, direction, z)
        return (x - dx, y - dy, new_z, d - 1), op

    init_walk = (ref_lens.astype(jnp.int32), read_lens.astype(jnp.int32),
                 z0, jnp.int32(D - 1))
    # reverse scan over diagonals (d = D-1 first); ys stay aligned to xs,
    # so ops_desc[i] is the op taken on diagonal i - already forward order
    _, ops_desc = jax.lax.scan(walk_step, init_walk, tb, reverse=True)
    ops_d = jnp.transpose(ops_desc, (1, 0))            # [B, D], fwd order
    return _ops_epilogue(ops_d, score, z0, n1=n1, n2=n2), tb_b


def _finish_local(tb, zflags, best, *, n1: int, n2: int):
    """Local-mode epilogue: walk from the Waterman-Eggert argmax cell,
    stopping at a border or a value-0.0 cell (perform_3d_global_traceback
    :941-986 local branch; no trailing D/I runs). tb/zflags are
    diagonal-major [D, B, n1]; best = (val, x, d, col[B,3])."""
    best_val, best_x, best_d, best_col = best
    B = tb.shape[1]
    D = n1 + n2 - 1
    best_y = best_d - best_x
    z0, score = _corner_to_z0_score(best_col)
    lane = jnp.arange(n1, dtype=jnp.int32)[None, :]

    def walk_step(state, inputs):
        tb_diag, z_diag = inputs
        x, y, z, d, done = state
        on_diag = (x + y == d) & jnp.logical_not(done)
        in_core = (x > 0) & (y > 0)
        zb = jnp.sum(
            jnp.where(lane == x[:, None], z_diag.astype(jnp.int32), 0),
            axis=1)
        at_zero = ((zb >> z) & 1) == 1
        emit = on_diag & in_core & jnp.logical_not(at_zero)
        stop = on_diag & (jnp.logical_not(in_core) | at_zero)
        op = jnp.where(emit, z.astype(jnp.uint8), jnp.uint8(OP_DONE))
        byte = jnp.sum(
            jnp.where(lane == x[:, None], tb_diag.astype(jnp.int32), 0),
            axis=1)
        direction = (byte >> (2 * z)) & 3
        dx = jnp.where(emit, jnp.where(z == 2, 0, 1), 0)
        dy = jnp.where(emit, jnp.where(z == 1, 0, 1), 0)
        new_z = jnp.where(emit, direction, z)
        return (x - dx, y - dy, new_z, d - 1, done | stop), op

    init_walk = (best_x, best_y, z0, jnp.int32(D - 1),
                 jnp.zeros((B,), bool))
    (end_x, end_y, _z, _d, _done), ops_desc = jax.lax.scan(
        walk_step, init_walk, (tb, zflags), reverse=True)
    ops_d = jnp.transpose(ops_desc, (1, 0))
    res = _ops_epilogue(ops_d, score, z0, n1=n1, n2=n2)
    return LocalBatchAlignment(
        score=res.score, start_z=res.start_z, ops=res.ops, n_ops=res.n_ops,
        ops_packed=res.ops_packed, ref_start=end_x, read_start=end_y,
        ref_end=best_x, read_end=best_y)


def _corner_to_z0_score(corner):
    # starting plane: argmax, later plane wins ties (Rust max_by keeps last)
    z0 = jnp.where(
        corner[:, 2] >= jnp.maximum(corner[:, 0], corner[:, 1]), 2,
        jnp.where(corner[:, 1] >= corner[:, 0], 1, 0)).astype(jnp.int32)
    score = jnp.take_along_axis(corner, z0[:, None], axis=1)[:, 0]
    return z0, score


@jax.jit
def fuse_result(ops_packed, n_ops, score):
    """Pack (n_ops i32, score f32, ops_packed u8[P]) into ONE uint8
    buffer [..., 8 + P], so the host pulls one array per dispatch instead
    of three. Host side: unfuse_result."""
    head_shape = n_ops.shape
    a = jax.lax.bitcast_convert_type(
        n_ops.astype(jnp.int32), jnp.uint8).reshape(*head_shape, 4)
    b = jax.lax.bitcast_convert_type(
        score.astype(jnp.float32), jnp.uint8).reshape(*head_shape, 4)
    return jnp.concatenate([a, b, ops_packed], axis=-1)


def unfuse_result(buf: np.ndarray):
    """Host inverse of fuse_result: (ops_packed, n_ops, score) views."""
    n_ops = np.ascontiguousarray(buf[..., 0:4]).view(np.int32)[..., 0]
    score = np.ascontiguousarray(buf[..., 4:8]).view(np.float32)[..., 0]
    return buf[..., 8:], n_ops, score


@jax.jit
def concat_fused(*bufs):
    """Concatenate K same-shape dispatches' fuse_result buffers along the
    batch axis so the host pulls ONE array for K groups; unlike the
    lax.scan wave, which serializes the fills, the K fills already ran
    as separate dispatches. Host side: slice rows back per group
    (align_pairs_entries pulls())."""
    return jnp.concatenate(bufs, axis=0)


@functools.partial(jax.jit, static_argnames=("n1", "n2", "special_mode",
                                             "fill", "tie_order",
                                             "mesh"))
def align_batch_device_wave(ref_row, reads, ref_lens, read_lens, bandwidth,
                            scoring_params, *, n1: int, n2: int,
                            special_mode: str = "both",
                            fill: str = "scan",
                            tie_order: str = "ref", mesh=None):
    """W same-shape uniform-reference batches in ONE device call.

    ref_row [1, n1-1] (the shared reference); reads [W, B, n2-1];
    lens/bandwidth [W, B]. lax.scan over the wave axis reuses one compiled
    inner fill+walk, so the host pays one dispatch + one result pull for
    W groups instead of W of each. Returns BatchAlignment with
    [W, B, ...] leaves."""
    def body(carry, xs):
        rd, rl, dl, bw = xs
        res, _tb = align_batch_device(
            ref_row, rd, rl, dl, bw, scoring_params, n1=n1, n2=n2,
            special_mode=special_mode, fill=fill,
            return_traceback=False, tie_order=tie_order, mesh=mesh)
        return carry, res

    _c, res = jax.lax.scan(body, None,
                           (reads, ref_lens, read_lens, bandwidth))
    return res


def _finish_from_packed_traceback(words, corner, ref_lens, read_lens,
                                  *, n1: int, n2: int):
    """Traceback walk directly over packed int32 words (pack_words, or the
    CUDA fill's output; 4 diagonals per word), skipping the [B, D, n1]
    uint8 unpack+transpose. words is word-major
    [Wd, B, n1] i32 where word w holds diagonals 4w..4w+3 at byte lanes
    (shift 8*(d%4)). Diagonals >= D walk as inactive (x+y < d -> DONE)."""
    Wd, B = words.shape[0], words.shape[1]
    D4 = 4 * Wd
    z0, score = _corner_to_z0_score(corner)
    lane = jnp.arange(n1, dtype=jnp.int32)[None, :]

    def walk_word(state, word):
        ops = []
        for k in (3, 2, 1, 0):          # diagonal 4w+k, descending
            x, y, z, d = state
            active = (x + y == d) & ((x > 0) | (y > 0))
            in_core = (x > 0) & (y > 0)
            op = jnp.where(
                active & in_core, z.astype(jnp.uint8),
                jnp.where(active & (x > 0), jnp.uint8(OP_DEL),
                          jnp.where(active & (y > 0), jnp.uint8(OP_INS),
                                    jnp.uint8(OP_DONE))))
            wsel = jnp.sum(
                jnp.where(lane == x[:, None], word, 0), axis=1)
            direction = (wsel >> (8 * k + 2 * z)) & 3

            step_core = active & in_core
            dx = jnp.where(step_core, jnp.where(z == 2, 0, 1),
                           jnp.where(active & (x > 0), 1, 0))
            dy = jnp.where(step_core, jnp.where(z == 1, 0, 1),
                           jnp.where(active & (x <= 0) & (y > 0), 1, 0))
            new_z = jnp.where(step_core, direction, z)
            state = (x - dx, y - dy, new_z, d - 1)
            ops.append(op)
        return state, jnp.stack(ops[::-1], axis=0)     # ascending diagonal

    init_walk = (ref_lens.astype(jnp.int32), read_lens.astype(jnp.int32),
                 z0, jnp.int32(D4 - 1))
    _, ops_desc = jax.lax.scan(walk_word, init_walk, words, reverse=True)
    # [Wd, 4, B] -> [D4, B] (ascending diagonals) -> [B, D4]
    ops_d = jnp.transpose(ops_desc.reshape(D4, B), (1, 0))
    return _ops_epilogue(ops_d, score, z0, n1=n1, n2=n2)


def _ops_epilogue(ops_d, score, z0, *, n1: int, n2: int):
    """Left-compact the walked ops and 2-bit pack them for transfer."""
    B, Dw = ops_d.shape
    n_ops = jnp.sum(ops_d != OP_DONE, axis=1).astype(jnp.int32)

    # left-compact the non-DONE ops preserving order (stable argsort on the
    # DONE mask)
    T = n1 + n2
    order = jnp.argsort((ops_d == OP_DONE).astype(jnp.int32), axis=1,
                        stable=True)
    ops_compact = jnp.take_along_axis(ops_d, order, axis=1)
    if Dw < T:
        ops_fwd = jnp.pad(ops_compact, ((0, 0), (0, T - Dw)),
                          constant_values=OP_DONE)
    else:
        ops_fwd = ops_compact[:, :T]

    # 2-bit packing (ops are 0..3) for cheap device->host transfer
    T4 = -(-T // 4) * 4
    o = jnp.pad(ops_fwd, ((0, 0), (0, T4 - T)),
                constant_values=OP_DONE).reshape(B, T4 // 4, 4)
    ops_packed = (o[:, :, 0] | (o[:, :, 1] << 2) | (o[:, :, 2] << 4)
                  | (o[:, :, 3] << 6)).astype(jnp.uint8)

    return BatchAlignment(score=score, start_z=z0, ops=ops_fwd, n_ops=n_ops,
                          ops_packed=ops_packed)


def band_centers_f64(ref_lens: np.ndarray, read_lens: np.ndarray,
                     n1: int) -> np.ndarray:
    """Reference-exact band centers, computed on host in float64.

    perform_affine_alignment_bandwidth derives the band center as
    `((x as f64 / (len1+1) as f64) * (len2+1) as f64) as i64`
    (alignment_matrix.rs:414): two f64 roundings that can land one BELOW
    the exact integer quotient (e.g. x=1, len1=48, len2=146: exact 3,
    f64 truncates to 2). Integer division inside the kernel cannot
    reproduce that; partial-band callers pass this [B, n1] table as
    align_batch_device's band_centers."""
    x = np.arange(n1, dtype=np.float64)[None, :]
    d1 = ref_lens.astype(np.float64)[:, None] + 1.0
    d2 = read_lens.astype(np.float64)[:, None] + 1.0
    return ((x / d1) * d2).astype(np.int32)


def scoring_to_params(scoring: AffineScoring) -> jnp.ndarray:
    scoring.assert_dyadic()
    return jnp.array(
        [scoring.match_score, scoring.mismatch_score,
         scoring.special_character_score, scoring.gap_open,
         scoring.gap_extend, scoring.final_gap_multiplier],
        dtype=jnp.float32)


def unpack_ops(ops_packed: np.ndarray, T: int) -> np.ndarray:
    """Host-side unpack of 2-bit op codes -> [B, T] uint8."""
    B = ops_packed.shape[0]
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    u = (ops_packed[:, :, None] >> shifts[None, None, :]) & 3
    return u.reshape(B, -1)[:, :T].astype(np.uint8)


# --- host-side helpers -------------------------------------------------------

def pad_batch(seqs, pad_to: Optional[int] = None):
    """list[bytes] -> (uint8 array [B, L], int32 lens [B])."""
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    L = int(pad_to if pad_to is not None else (max(lens) if len(lens) else 0))
    out = np.zeros((len(seqs), max(L, 1)), dtype=np.uint8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = np.frombuffer(
            s if isinstance(s, bytes) else bytes(s), dtype=np.uint8)
    return out, lens


def ops_to_alignments_batch(ops: np.ndarray, n_ops: np.ndarray,
                            refs_arr: np.ndarray, reads_arr: np.ndarray):
    """Vectorized expansion of a whole batch of op sequences.

    ops [B, T] uint8 (OP_DONE-padded), n_ops [B], refs_arr [B, Lr],
    reads_arr [B, Ld] -> (aligned_ref [B, T] uint8, aligned_read [B, T]
    uint8, valid [B, T] bool). Rows are GAP/0-padded past n_ops; callers
    slice row[:n_ops[b]].
    """
    from clique_tpu.utils.seq import GAP

    B, T = ops.shape
    valid = ops != OP_DONE
    r_step = valid & (ops != OP_INS)
    d_step = valid & (ops != OP_DEL)
    r_idx = np.cumsum(r_step, axis=1, dtype=np.int32)
    d_idx = np.cumsum(d_step, axis=1, dtype=np.int32)
    np.subtract(r_idx, 1, out=r_idx)
    np.subtract(d_idx, 1, out=d_idx)
    np.clip(r_idx, 0, refs_arr.shape[1] - 1, out=r_idx)
    np.clip(d_idx, 0, reads_arr.shape[1] - 1, out=d_idx)
    # flat fancy gather ~2x faster than take_along_axis at these shapes;
    # int32 index arithmetic avoids an int64 upcast pass
    rows = np.arange(B, dtype=np.int32)[:, None]
    ref_g = refs_arr.ravel()[r_idx + rows * np.int32(refs_arr.shape[1])]
    read_g = reads_arr.ravel()[d_idx + rows * np.int32(reads_arr.shape[1])]
    aligned_ref = np.where(r_step, ref_g, GAP).astype(np.uint8)
    aligned_read = np.where(d_step, read_g, GAP).astype(np.uint8)
    aligned_ref[~valid] = 0
    aligned_read[~valid] = 0
    return aligned_ref, aligned_read, valid


def cigar_from_ops_row(ops_row: np.ndarray, n: int):
    """Run-length encode one op row into [(count, op)] (M/D/I)."""
    from clique_tpu.align.cpu import simplify_cigar

    ops_row = ops_row[:n]
    if n == 0:
        return []
    change = np.nonzero(np.diff(ops_row))[0]
    starts = np.concatenate(([0], change + 1))
    ends = np.concatenate((change + 1, [n]))
    return [(int(e - s), "MDI"[ops_row[s]]) for s, e in zip(starts, ends)]


def cigar_runs_from_ops_batch(ops: np.ndarray, n_ops: np.ndarray):
    """Flat run-length encoding of a whole [B, T] op matrix in one pass:
    (counts int32 [R], opcodes uint8 [R] with 0=M 1=D 2=I, bounds int64
    [B+1] into the run arrays). The flat form feeds the native fast-path
    BAM assembler directly; cigars_from_ops_batch builds the per-row
    tuple lists from it."""
    B, T = ops.shape
    z64 = np.zeros(1, dtype=np.int64)
    if B == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.uint8), z64)
    j = np.arange(T, dtype=np.int64)
    valid = j[None, :] < n_ops[:, None]
    o = np.where(valid, ops, 255).astype(np.int16)
    prev = np.empty_like(o)
    prev[:, 0] = -1                       # row start always opens a run
    prev[:, 1:] = o[:, :-1]
    start = valid & (o != prev)
    rows, cols = np.nonzero(start)
    if len(rows) == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.uint8),
                np.zeros(B + 1, dtype=np.int64))
    ends = np.empty_like(cols)
    ends[:-1] = cols[1:]
    row_last = np.empty(len(rows), dtype=bool)
    row_last[:-1] = rows[1:] != rows[:-1]
    row_last[-1] = True
    ends[row_last] = n_ops[rows[row_last]]
    counts = (ends - cols).astype(np.int32)
    opcodes = ops[rows, cols].astype(np.uint8)
    bounds = np.searchsorted(rows, np.arange(B + 1)).astype(np.int64)
    return counts, opcodes, bounds


def cigars_from_runs(counts, opcodes, bounds):
    """Per-row [(count, op)] tuple lists from cigar_runs_from_ops_batch
    output."""
    counts_l = counts.tolist()
    ops_l = opcodes.tolist()
    bounds_l = bounds.tolist()
    sym = "MDI"
    return [[(c, sym[v]) for c, v in
             zip(counts_l[s:e], ops_l[s:e])]
            for s, e in zip(bounds_l[:-1], bounds_l[1:])]


def cigars_from_ops_batch(ops: np.ndarray, n_ops: np.ndarray):
    """Run-length encode a whole [B, T] op matrix into per-row
    [(count, op)] lists with one flat pass (no per-row numpy calls - the
    per-read cigar_from_ops_row overhead dominated the align host time at
    20k reads/batch)."""
    return cigars_from_runs(*cigar_runs_from_ops_batch(ops, n_ops))


def ops_to_alignment(ops: np.ndarray, n_ops: int, ref: bytes, read: bytes):
    """Expand a forward op sequence into (ref_aligned, read_aligned, cigar).

    Mirrors the string/CIGAR construction of perform_3d_global_traceback.
    """
    from clique_tpu.align.cpu import simplify_cigar
    from clique_tpu.utils.seq import GAP

    ops = ops[:n_ops]
    r_idx = np.cumsum(ops != OP_INS)      # consumed ref bases after each op
    d_idx = np.cumsum(ops != OP_DEL)      # consumed read bases
    ref_a = np.frombuffer(ref, dtype=np.uint8)
    read_a = np.frombuffer(read, dtype=np.uint8)

    aln1 = np.where(ops != OP_INS, ref_a[np.clip(r_idx - 1, 0, None)], GAP).astype(np.uint8)
    aln2 = np.where(ops != OP_DEL, read_a[np.clip(d_idx - 1, 0, None)], GAP).astype(np.uint8)

    cigar = simplify_cigar([(1, "MDI"[o]) for o in ops])
    return aln1.tobytes(), aln2.tobytes(), cigar
