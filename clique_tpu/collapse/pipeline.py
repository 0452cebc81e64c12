"""The `collapse` pipeline: tagged BAM -> hierarchically corrected /
collapsed consensus BAM.

Re-design of /root/reference/rust_cmd/src/collapse.rs (collapse :70-141,
sort_reads_from_bam_file :427-579, sort_level :859-992) and
consensus_builders.rs (write_consensus_reads :74-165, write_corrected_reads
:34-71). Where the reference streams through shardio external-memory sorts,
we hold the per-reference read set in memory (amplicon runs fit; a spill
path can shard by tag hash later - the same hash partitioning that becomes
the cross-host all-to-all in the distributed setting) and run the tag
corrections as batched device kernels over whole levels at once.

Per level (= one UMIConfiguration, in `order`):
- group reads by the already-corrected key tuple;
- within each group, count the next tag (gap-stripped, length-gated to
  length +- max_distance at push time, correct_tags.rs:79-107);
- build the correction map by sort_type (KnownTag trie/Hamming,
  DegenerateTag starcode clustering - collapse/correct.py);
- apply: corrected reads advance with (symbol, original, corrected) pushed
  onto their sorting keys; KnownTag misses are dropped
  (correct_tags.rs:334-375).

Finally each equal-key group is collapsed through the stretcher column
consensus (consensus/stretcher.py) or passed through with --correct-only.
"""

from __future__ import annotations

import logging
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

# NOTE: clique_tpu.collapse.correct (-> distance -> jax) is imported
# lazily inside the level functions so this module stays importable by the
# jax-free worker processes of the host-parallel collapse
# (collapse/workers.py); workers pickle SortingRead by reference to this
# module and run ingestion/consensus only.
from clique_tpu.config.layout import (
    SequenceLayout,
    UMIConfiguration,
    UMISortType,
)
from clique_tpu.consensus.stretcher import AlignmentCandidate
from clique_tpu.extract.extractor import (
    alignment_rate_fast,
    extract_tag_sequences,
    extract_tagged_sequences,
    recover_aligned_sequences,
    recover_aligned_sequences_fast,
    stretch_sequence_to_alignment,
    stretch_sequence_to_alignment_fast,
)
from clique_tpu.io.sam import BamReader, SamRecord, open_alignment_writer
from clique_tpu.reference.manager import ReferenceManager
from clique_tpu.utils.seq import FASTA_N, GAP

log = logging.getLogger(__name__)


@dataclass
class SortingRead:
    """SortingReadSetContainer (read_disk_sorter.rs:41-105)."""

    read_name: str
    reference_name: str
    reference_aligned: bytes
    read_aligned: bytes
    read_quals: Optional[bytes]
    cigar: List[Tuple[int, str]]
    reference_start: int
    score: float
    # [(symbol, original, corrected)] in correction order
    sorting_keys: List[Tuple[str, bytes, bytes]] = field(default_factory=list)
    # [(symbol, raw bytes)] not yet corrected
    unsorted_keys: Deque[Tuple[str, bytes]] = field(default_factory=deque)
    # heavy-payload pointer for the host-parallel path: (blob_path, offset,
    # size) of a pickled (reference_aligned, read_aligned, read_quals,
    # cigar) tuple written by the ingest worker. When set, those four
    # fields may be empty placeholders — correction levels never touch
    # them, and consensus workers rehydrate from the blob file
    # (collapse/workers.py) instead of shipping ~1.5KB/read over pipes.
    blob: Optional[Tuple[str, int, int]] = None
    # monotone input-BAM position (per reference): group members are
    # sorted by it before consensus in every path, so member order (the
    # consensus read name, ar tag order, downsample cap) equals input
    # order whether the run was in-RAM, out-of-core, or distributed
    ordinal: int = 0
    # precomputed AlignmentCheck verdict: _ingest_class evaluates the
    # filter vectorized on its [G, L] matrix (same math as
    # alignment_check_batch) and stamps it here so the batch check never
    # re-marshals the row's bytes. Only valid within the ingesting
    # _RefIngest (same min_aligned_bases/min_identical at stamp and use);
    # None = not precomputed, the batch check computes it.
    ac_keep: Optional[bool] = None
    # in-RAM level-grouping class id: sort_level threads an integer
    # equivalence class through the levels (level k's bin x corrected
    # value => level k+1's class), replacing per-read key_tuple()
    # construction + long bytes-tuple hashing on the hot grouping path.
    # By induction gid classes == (reference, corrected-key-prefix)
    # classes; output-order sorts still use key_tuple()
    gid: int = 0

    def key_tuple(self) -> Tuple[bytes, ...]:
        return tuple(corrected for _s, _o, corrected in self.sorting_keys)

    def spill_key(self) -> Tuple:
        """Hash-partition / grouping key for the out-of-core shards:
        (reference, corrected keys so far, gap-stripped NEXT uncorrected
        tag). Including the next raw tag keeps level-0 spills partitioned
        (every read's key_tuple() is empty there - without it the whole
        dataset hashes to one shard) and bounds every later group to reads
        sharing both the corrected prefix and the raw next tag. Grouping
        by corrected prefix alone is recovered by ignoring the last
        component - which the level passes do by streaming per-read."""
        nxt = self.unsorted_keys[0][1].replace(b"-", b"") \
            if self.unsorted_keys else b""
        return (self.reference_name,) + self.key_tuple() + (nxt,)


def alignment_check(read: SortingRead, min_aligned_bases: int = 45,
                    min_identical: float = 0.8) -> bool:
    """AlignmentCheck filter (collapse.rs:251-279): over columns where both
    bytes are > 59 and the reference isn't N, require >= min_aligned_bases
    alignable columns at >= min_identical identity."""
    import numpy as np

    x = np.frombuffer(read.read_aligned, dtype=np.uint8)
    y = np.frombuffer(read.reference_aligned, dtype=np.uint8)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    mask = (y > 59) & (x > 59) & (y != FASTA_N)
    alignable = int(mask.sum())
    if alignable == 0:
        return False
    matches = int(((x == y) & mask).sum())
    return (matches / alignable >= min_identical) and \
        (alignable >= min_aligned_bases)


def flanking_degenerate_base_filter(read: SortingRead,
                                    min_flanking_identity: float = 0.50,
                                    flanking_window_size: int = 10) -> bool:
    """FlankingDegenerateBaseFilter (collapse.rs:284-344): require the
    sequence windows flanking each degenerate capture zone to match the
    reference at >= min_flanking_identity. Present-but-disabled in the
    reference's filter list; exposed here for layouts that opt in."""
    pushed: List[int] = []
    ret = True
    count_down = None

    for read_base, ref_base in zip(read.read_aligned,
                                   read.reference_aligned):
        if count_down == 0:
            count_down = None
            lookback = min(len(pushed), flanking_window_size)
            if lookback:
                prop = sum(pushed[-lookback:]) / lookback
                if prop < min_flanking_identity:
                    ret = False
            pushed.clear()
        elif ref_base > 58 and ref_base != FASTA_N:
            if count_down is not None:
                count_down -= 1
            pushed.append(1 if read_base == ref_base else 0)
        elif ref_base < 59 and pushed:
            lookback = min(len(pushed), flanking_window_size)
            prop = sum(pushed[-lookback:]) / lookback
            pushed.clear()
            if prop < min_flanking_identity:
                ret = False
        elif ref_base == FASTA_N and not pushed:
            count_down = flanking_window_size
    return ret


@dataclass
class CollapseStats:
    total_reads: int = 0
    unmapped: int = 0
    secondary: int = 0
    failed_filters: int = 0
    invalid_tags: int = 0
    duplicate_reads: int = 0
    passing: int = 0

    def passing_reads(self) -> int:
        """Derived count as BamReadFiltering::passing_reads (collapse.rs):
        total minus every filter bucket (failed creations are already part
        of failed_filters here)."""
        return (self.total_reads - self.unmapped - self.secondary
                - self.failed_filters - self.duplicate_reads
                - self.invalid_tags)


class _RefIngest:
    """Per-reference ingestion state for the single-pass BAM scan.

    Records are buffered and drained in batches: the dominant read class
    (all-M/=/X CIGARs sharing (pos, span) — amplicon reads) goes through a
    fully vectorized recovery + digit-capture + validity pass over one
    [G, L] matrix; everything else falls back to the per-read path. Output
    order and semantics are identical to per-record ingestion."""

    _DRAIN_AT = 4096

    def __init__(self, reference_name: str, rm: ReferenceManager,
                 layout: SequenceLayout, spill=None,
                 min_aligned_bases: int = 45, min_identical: float = 0.8):
        ref_id = rm.name_to_id[reference_name]
        self.name = reference_name
        self.sequence = rm.references[ref_id].sequence
        self.cfg = layout.references[reference_name]
        self.symbols = [u.symbol for u in self.cfg.umi_configurations.values()]
        self.all_digits = all(s.isdigit() for s in self.symbols)
        self.spill = spill
        self.out: List[SortingRead] = []
        self.n_passing = 0
        # AlignmentCheck knobs (collapse.rs:455-459 hardcodes 45/0.8;
        # SURVEY section 5 asks for them lifted into config)
        self.min_aligned_bases = min_aligned_bases
        self.min_identical = min_identical
        self._buf: List[SamRecord] = []
        self._buf_ords: List[int] = []
        # next read's input-position stamp; the distributed ingest resets
        # it per byte-range chunk so ordinals stay globally monotone
        self._next_ordinal = 0
        # per-symbol wildcard positions in the native reference (the
        # stretched reference equals the native one for gapless alignments,
        # so digit capture is a fixed column gather for the whole class)
        import numpy as np

        seq_a = np.frombuffer(self.sequence, dtype=np.uint8)
        self._sym_pos = {u.symbol: np.nonzero(seq_a == ord(u.symbol))[0]
                         for u in self.cfg.umi_configurations.values()}
        self._ordered_umis = sorted(self.cfg.umi_configurations.values(),
                                    key=lambda u: u.order)

    def ingest(self, rec: SamRecord, stats: "CollapseStats") -> None:
        self._buf.append(rec)
        self._buf_ords.append(self._next_ordinal)
        self._next_ordinal += 1
        if len(self._buf) >= self._DRAIN_AT:
            self._drain(stats)

    def _ingest_one(self, rec: SamRecord) -> Optional[SortingRead]:
        """Per-read path (soft clips / indel CIGARs / extractor zones);
        returns None when tag validation fails."""
        from clique_tpu.extract.extractor import extract_digit_tags_fast

        fast = recover_aligned_sequences_fast(
            rec.seq, rec.pos, rec.cigar, self.sequence)
        if fast is not None:
            aligned_read, aligned_ref = fast
            stretched = stretch_sequence_to_alignment_fast(
                aligned_ref, self.sequence)
        else:
            aligned_read, aligned_ref = recover_aligned_sequences(
                rec.seq, rec.pos, rec.cigar, self.sequence,
                soft_clip="Realign")
            stretched = stretch_sequence_to_alignment(
                aligned_ref, self.sequence)
        if self.all_digits:
            tags = {ord(s): v for s, v in extract_digit_tags_fast(
                aligned_read, stretched, self.symbols).items()}
        else:
            tags = extract_tagged_sequences(aligned_read, stretched)
        invalid, ordered = extract_tag_sequences(self.cfg, tags)
        if invalid:
            return None
        return SortingRead(
            read_name=rec.name,
            reference_name=self.name,
            reference_aligned=aligned_ref,
            read_aligned=aligned_read,
            read_quals=rec.qual if rec.qual != b"*" else None,
            cigar=list(rec.cigar),
            reference_start=rec.pos,
            score=0.0,
            unsorted_keys=deque(ordered),
        )

    def _ingest_class(self, buf: List[SamRecord], idxs: List[int], pos: int,
                      n: int, results: List[Optional[SortingRead]]) -> None:
        """Vectorized ingestion of one (pos, span) all-match class: the
        aligned read is the sequence gap-padded into the reference frame,
        the stretched reference IS the native wildcard reference, and every
        row shares the same digit-capture columns."""
        import numpy as np

        L = len(self.sequence)
        G = len(idxs)
        mat = np.full((G, L), GAP, dtype=np.uint8)
        block = b"".join(buf[i].seq[:n] for i in idxs)
        mat[:, pos - 1:pos - 1 + n] = \
            np.frombuffer(block, dtype=np.uint8).reshape(G, n)
        invalid = np.zeros(G, dtype=bool)
        # AlignmentCheck (alignment_check_batch's math) vectorized on the
        # class matrix: reference row == the native sequence for every row
        seq_a = np.frombuffer(self.sequence, dtype=np.uint8)
        ref_ok = (seq_a > 59) & (seq_a != FASTA_N)
        m = ref_ok[None, :] & (mat > 59)
        alignable = m.sum(axis=1)
        matches = ((mat == seq_a[None, :]) & m).sum(axis=1)
        keep = (alignable > 0) & (alignable >= self.min_aligned_bases) & \
            (matches / np.maximum(alignable, 1) >= self.min_identical)
        tag_cols: List[Tuple[str, "np.ndarray"]] = []
        for umi in self._ordered_umis:
            pidx = self._sym_pos.get(umi.symbol)
            if pidx is None or len(pidx) == 0:
                # missing capture: invalid, tag not collected
                # (extract_tag_sequences, extractor.rs:355-410)
                invalid[:] = True
                continue
            cap = mat[:, pidx]
            if cap.shape[1] != umi.length:
                invalid[:] = True
            if umi.max_gaps is not None:
                invalid |= (cap == GAP).sum(axis=1) > umi.max_gaps
            tag_cols.append((umi.symbol, cap))
        row_bytes = mat.tobytes()
        for j, i in enumerate(idxs):
            if invalid[j]:
                continue
            rec = buf[i]
            ordered = [(sym, cap[j].tobytes()) for sym, cap in tag_cols]
            results[i] = SortingRead(
                read_name=rec.name,
                reference_name=self.name,
                reference_aligned=self.sequence,
                read_aligned=row_bytes[j * L:(j + 1) * L],
                read_quals=rec.qual if rec.qual != b"*" else None,
                cigar=list(rec.cigar),
                reference_start=rec.pos,
                score=0.0,
                unsorted_keys=deque(ordered),
                ac_keep=bool(keep[j]),
            )

    def _drain(self, stats: "CollapseStats") -> None:
        if not self._buf:
            return
        buf, self._buf = self._buf, []
        ords, self._buf_ords = self._buf_ords, []
        results: List[Optional[SortingRead]] = [None] * len(buf)
        slow: List[int] = []
        classes: Dict[Tuple[int, int], List[int]] = {}
        if self.all_digits:
            L = len(self.sequence)
            for i, rec in enumerate(buf):
                cig = rec.cigar
                if cig and all(op in "M=X" for _c, op in cig):
                    n = sum(c for c, _op in cig)
                    if rec.pos >= 1 and rec.pos - 1 + n <= L and \
                            len(rec.seq) >= n:
                        classes.setdefault((rec.pos, n), []).append(i)
                        continue
                slow.append(i)
        else:
            slow = list(range(len(buf)))
        for (pos, n), idxs in classes.items():
            self._ingest_class(buf, idxs, pos, n, results)
        for i in slow:
            results[i] = self._ingest_one(buf[i])
        for r, o in zip(results, ords):
            if r is None:
                stats.invalid_tags += 1
            else:
                r.ordinal = o
                self.out.append(r)
        if self.spill is not None and len(self.out) >= 8192:
            self.n_passing += _filter_chunk(self.out, stats, self.spill,
                                            self.min_aligned_bases,
                                            self.min_identical)

    def finish(self, stats: "CollapseStats") -> List[SortingRead]:
        self._drain(stats)
        if self.spill is not None:
            self.n_passing += _filter_chunk(self.out, stats, self.spill,
                                            self.min_aligned_bases,
                                            self.min_identical)
            return []
        keep = alignment_check_batch(self.out, self.min_aligned_bases,
                                     self.min_identical)
        passing = [r for r, k in zip(self.out, keep) if k]
        stats.passing += len(passing)
        stats.failed_filters += len(self.out) - len(passing)
        self.n_passing += len(passing)
        self.out = []
        return passing


def ingest_bam_single_pass(input_bam: str, ingests: Dict[str, "_RefIngest"],
                           stats: CollapseStats) -> Dict[str, List[SortingRead]]:
    """ONE streaming scan over the BAM routing records to per-reference
    ingestion states. The reference re-queries the indexed BAM once per
    reference region (collapse.rs:437-491) - on a 180-guide panel that is
    180 range scans of one file; a single pass with per-reference routing
    reads the input exactly once."""
    with BamReader(input_bam, parse_tags=False) as reader:
        for rec in reader:
            ing = ingests.get(rec.reference_name or "")
            if ing is None:
                continue
            stats.total_reads += 1
            if rec.flag & 0x100:
                stats.secondary += 1
                continue
            if rec.flag & 0x4:
                stats.unmapped += 1
                continue
            ing.ingest(rec, stats)
    return {name: ing.finish(stats) for name, ing in ingests.items()}


def read_sorting_reads_from_bam(input_bam: str, reference_name: str,
                                rm: ReferenceManager, layout: SequenceLayout,
                                stats: CollapseStats,
                                spill=None) -> List[SortingRead]:
    """sort_reads_from_bam_file (collapse.rs:427-579) for ONE reference:
    stream its records, rebuild the gapped alignment (soft clips
    realigned), stretch the wildcard-bearing reference back in, extract +
    validate tags, filter. Kept for single-reference callers/tests; the
    collapse pipeline ingests every reference in one pass via
    ingest_bam_single_pass."""
    ing = _RefIngest(reference_name, rm, layout, spill=spill)
    return ingest_bam_single_pass(input_bam, {reference_name: ing},
                                  stats)[reference_name]


def _filter_chunk(out: List[SortingRead], stats: CollapseStats,
                  spill, min_aligned_bases: int = 45,
                  min_identical: float = 0.8) -> int:
    keep = alignment_check_batch(out, min_aligned_bases, min_identical)
    n_pass = 0
    for r, k in zip(out, keep):
        if k:
            spill.push(r.spill_key(), r)
            n_pass += 1
    stats.passing += n_pass
    stats.failed_filters += len(out) - n_pass
    out.clear()
    return n_pass


def alignment_check_batch(reads: List[SortingRead],
                          min_aligned_bases: int = 45,
                          min_identical: float = 0.8) -> List[bool]:
    """Vectorized alignment_check over a whole read set: one padded
    [N, Lmax] comparison instead of per-read numpy round trips. Rows
    whose verdict was already stamped by _ingest_class (ac_keep) skip
    the re-marshal entirely."""
    import numpy as np

    if not reads:
        return []
    out: List[Optional[bool]] = [r.ac_keep for r in reads]
    todo = [i for i, k in enumerate(out) if k is None]
    if not todo:
        return out
    lens = [min(len(reads[i].read_aligned),
                len(reads[i].reference_aligned)) for i in todo]
    L = max(lens)
    x = np.zeros((len(todo), L), dtype=np.uint8)
    y = np.zeros((len(todo), L), dtype=np.uint8)
    for j, i in enumerate(todo):
        r = reads[i]
        n = lens[j]
        x[j, :n] = np.frombuffer(r.read_aligned[:n], dtype=np.uint8)
        y[j, :n] = np.frombuffer(r.reference_aligned[:n], dtype=np.uint8)
    mask = (y > 59) & (x > 59) & (y != FASTA_N)
    alignable = mask.sum(axis=1)
    matches = ((x == y) & mask).sum(axis=1)
    safe = np.maximum(alignable, 1)
    ok = (alignable > 0) & (matches / safe >= min_identical) & \
        (alignable >= min_aligned_bases)
    for j, i in enumerate(todo):
        out[i] = bool(ok[j])
    return out


def load_known_lists(layout: SequenceLayout) -> Dict[str, List[bytes]]:
    """get_known_level_lookups (collapse.rs:779-818): load each allowlist
    file once, reverse-complementing when configured."""
    from clique_tpu.utils.seq import reverse_complement

    lists: Dict[str, List[bytes]] = {}
    for ref in layout.references.values():
        for cfg in ref.umi_configurations.values():
            if cfg.file and cfg.file not in lists:
                with open(cfg.file, "rb") as fh:
                    seqs = [line.strip() for line in fh if line.strip()]
                if cfg.reverse_complement_sequences:
                    seqs = [reverse_complement(s) for s in seqs]
                lists[cfg.file] = seqs
    return lists


def sort_level(reads: List[SortingRead], tag: UMIConfiguration,
               known_lists: Dict[str, List[bytes]]) -> List[SortingRead]:
    """One correction level (collapse.rs:859-992 + correct_tags.rs): group by
    prior keys, correct the next tag within each group, re-emit.

    Groups are built by dict insertion (first-seen order) rather than a
    global sort: intra-group member order is the scan order either way
    (sorted() is stable), group CONTENT is order-independent, and the final
    write_outputs re-sorts globally — so records are identical while the
    O(n log n) tuple-compare sort becomes O(n). Grouping keys on the
    integer gid class threaded by the previous level (== grouping by
    (reference, key_tuple()): every call site feeds per-reference reads
    whose gids start 0 and evolve per (bin, corrected value))."""
    grouped: "OrderedDict" = {}
    for r in reads:
        grouped.setdefault(r.gid, []).append(r)
    groups: List[List[SortingRead]] = list(grouped.values())

    # phase 1: per-group counts (push() length gating)
    group_counts: List[Counter] = []
    group_kept: List[List[SortingRead]] = []
    for group in groups:
        counts: Counter = Counter()
        kept: List[SortingRead] = []
        for read in group:
            gapless = _gate_tag(read, tag)
            if gapless is not None:
                counts[gapless] += 1
                kept.append(read)
        group_counts.append(counts)
        group_kept.append(kept)

    # phase 2: corrections - degenerate levels batch every group's pair
    # distances into one device call
    from clique_tpu.collapse.correct import correct_degenerate_groups

    if tag.sort_type == UMISortType.DEGENERATE_TAG:
        corrections = correct_degenerate_groups(
            group_counts, tag.max_distance, tag.length,
            tag.minimum_collapsing_difference or 5.0)
    else:
        corrections = [
            _known_correction(counts, tag, known_lists)
            for counts in group_counts]

    # phase 3: apply; child gids assigned per (bin, corrected value)
    out: List[SortingRead] = []
    next_gid = 0
    for kept, correction in zip(group_kept, corrections):
        applied = _apply_correction(kept, tag, correction)
        local: Dict[bytes, int] = {}
        for read in applied:
            corrected = read.sorting_keys[-1][2]
            g = local.get(corrected)
            if g is None:
                g = next_gid
                next_gid += 1
                local[corrected] = g
            read.gid = g
        out.extend(applied)
    log.info("level %s (%s): %d groups, %d reads in, %d passed",
             tag.symbol, tag.sort_type.value, len(groups), len(reads),
             len(out))
    return out


def _gate_tag(read: SortingRead, tag: UMIConfiguration) -> Optional[bytes]:
    """Phase-1 length gate: the gap-stripped next tag, or None if outside
    length +- max_distance (push() gating, correct_tags.rs:50-120)."""
    sym, raw = read.unsorted_keys[0]
    assert sym == tag.symbol, f"tag order mismatch: {sym} vs {tag.symbol}"
    gapless = raw.replace(b"-", b"")
    if tag.length - tag.max_distance <= len(gapless) <= \
            tag.length + tag.max_distance:
        return gapless
    return None


def sort_level_spill(in_dir, tag: UMIConfiguration,
                     known_lists: Dict[str, List[bytes]], out_dir: str,
                     n_shards: int = 32) -> Tuple[int, int]:
    """Out-of-core sort_level: two streaming passes over the input shards.

    Pass 1 streams reads frame-by-frame and accumulates one tag Counter
    per correction bin (= prior corrected-key tuple); pass 2 streams
    again, applies the precomputed correction maps per read, and respills.
    Only tag counters and correction maps stay in RAM - the per-bin
    resident read count is O(1), which strictly satisfies the reference's
    `maximum_subsequences` buffer cap (collapse.rs:884-888 /
    correct_tags.rs:50-120: cap the in-RAM bin buffer, spill the rest,
    never drop). `in_dir` may be a list of directories (multi-worker
    spills). Returns (reads_in, reads_out)."""
    from clique_tpu.collapse.shards import ShardWriter, iter_items

    counts_by_bin: Dict[Tuple, Counter] = {}
    n_in = 0
    for _key, read in iter_items(in_dir):
        n_in += 1
        gapless = _gate_tag(read, tag)
        if gapless is not None:
            bin_key = (read.reference_name,) + read.key_tuple()
            counts_by_bin.setdefault(bin_key, Counter())[gapless] += 1

    bins = list(counts_by_bin)
    from clique_tpu.collapse.correct import correct_degenerate_groups

    if tag.sort_type == UMISortType.DEGENERATE_TAG:
        corrections = correct_degenerate_groups(
            [counts_by_bin[b] for b in bins], tag.max_distance, tag.length,
            tag.minimum_collapsing_difference or 5.0)
    else:
        corrections = [_known_correction(counts_by_bin[b], tag, known_lists)
                       for b in bins]
    corr_by_bin = dict(zip(bins, corrections))

    n_out = 0
    with ShardWriter(out_dir, n_shards=n_shards) as out_writer:
        for _key, read in iter_items(in_dir):
            if _gate_tag(read, tag) is None:
                continue
            bin_key = (read.reference_name,) + read.key_tuple()
            out = _apply_correction_one(read, tag, corr_by_bin[bin_key])
            if out is not None:
                out_writer.push(out.spill_key(), out)
                n_out += 1
    log.info("level %s (%s, out-of-core): %d bins, %d reads in, %d passed",
             tag.symbol, tag.sort_type.value, len(bins), n_in, n_out)
    return n_in, n_out


def write_outputs_spill(directory: str, writer, rm: ReferenceManager,
                        correct_only: bool, downsample_cap: int = 40,
                        gap_call_threshold: float = 0.75) -> int:
    """Streaming write_outputs over final spill shards. Group contents
    match the in-RAM path; record ORDER follows shard order rather than a
    global key sort (grouping, not order, is the contract)."""
    from clique_tpu.collapse.shards import iter_sorted_groups

    ref_seqs = ref_seq_map(rm)
    written = 0
    records = []
    for _key, group in iter_sorted_groups(directory):
        units = [[r] for r in group] if correct_only else [group]
        for g in units:
            rec = _consensus_record(g, ref_seqs,
                                    downsample_cap if not correct_only else 0,
                                    gap_call_threshold, None)
            if rec is not None:
                records.append(rec)
                written += 1
        if len(records) >= 2048:
            _write_records(writer, records)
            records = []
    _write_records(writer, records)
    return written


def _write_records(writer, records) -> None:
    if not records:
        return
    if hasattr(writer, "write_batch"):
        writer.write_batch(records)
    else:
        for rec in records:
            writer.write(rec)


def _known_correction(counts: Counter, tag: UMIConfiguration,
                      known_lists: Dict[str, List[bytes]]):
    """KnownTag correction dispatch (collapse.rs:926-941).

    Deliberate deviation: the reference sends levenshtein_distance=None to
    the HAMMING closer (collapse.rs:928 `None | Some(false)`), but its
    lookup builder only made a trie for None (collapse.rs:779-818), so the
    None case panics on the missing VP-tree - reference UB. We route None
    to the Levenshtein/trie correction to match the lookup builder's
    intent; _apply_correction's raw-gapless-key fallback condition mirrors
    this choice (hamming-only when levenshtein_distance is explicitly
    False)."""
    from clique_tpu.collapse.correct import (
        correct_known_hamming,
        correct_known_levenshtein,
        normalize_tag,
    )

    allow = known_lists.get(tag.file or "", [])
    if not allow:
        # KnownTag without an allowlist file: the reference engine
        # panics here (correct_tags.rs:394-399 unwraps a missing trie);
        # we pass tags through uncorrected instead
        log.warning(
            "KnownTag level %s has no allowlist file; passing tags "
            "through uncorrected", tag.symbol)
        return {normalize_tag(t, tag.length): normalize_tag(t, tag.length)
                for t in counts}
    if tag.levenshtein_distance is None or tag.levenshtein_distance:
        return correct_known_levenshtein(
            counts, allow, tag.max_distance, tag.length)
    return correct_known_hamming(
        counts, allow, tag.max_distance, tag.length)


def _apply_correction_one(read: SortingRead, tag: UMIConfiguration,
                          correction) -> Optional[SortingRead]:
    """Apply one bin's correction map to a single read (add_corrected,
    correct_tags.rs:334-375). Returns None for dropped KnownTag misses."""
    from clique_tpu.collapse.correct import normalize_tag

    sym, raw = read.unsorted_keys.popleft()
    key_norm = normalize_tag(raw, tag.length)
    corrected = correction.get(key_norm)
    if corrected is None and tag.sort_type == UMISortType.KNOWN_TAG and \
            not (tag.levenshtein_distance is None or
                 tag.levenshtein_distance):
        # hamming path keys its map on the raw gapless tag
        gapless = raw.replace(b"-", b"")    # GAP == ord('-')
        corrected = correction.get(gapless)
    if corrected is None:
        if tag.sort_type == UMISortType.DEGENERATE_TAG:
            raise RuntimeError(
                f"Unable to find match for key {key_norm!r} in corrected "
                f"values")
        return None  # KnownTag miss: dropped (correct_tags.rs:360)
    read.sorting_keys.append((tag.symbol, key_norm, corrected))
    return read


def _apply_correction(kept: List[SortingRead], tag: UMIConfiguration,
                      correction) -> List[SortingRead]:
    out: List[SortingRead] = []
    for read in kept:
        applied = _apply_correction_one(read, tag, correction)
        if applied is not None:
            out.append(applied)
    return out


def write_outputs(reads: List[SortingRead], writer, rm: ReferenceManager,
                  correct_only: bool, downsample_cap: int = 40,
                  gap_call_threshold: float = 0.75,
                  record_tap: Optional[List[SamRecord]] = None,
                  phase_out: Optional[dict] = None) -> int:
    """write_consensus_reads / write_corrected_reads
    (consensus_builders.rs:34-165). phase_out (optional dict) receives a
    wall breakdown: group/sort, batched consensus precompute, the record
    loop, and the encode-thread join."""
    t0 = time.time()
    ref_seqs = ref_seq_map(rm)
    # group by the level-threaded gid class in O(n), then sort only the
    # GROUP keys (G << N) by (reference, corrected key tuple) — the same
    # record order as sorting every read (the old per-read tuple sort was
    # the growing term at >40k reads), with members in scan order exactly
    # as the stable sort kept them
    grouped: Dict[Tuple[str, int], List[SortingRead]] = {}
    for r in reads:
        grouped.setdefault((r.reference_name, r.gid), []).append(r)
    gs = sorted(grouped.values(),
                key=lambda g: (g[0].reference_name, g[0].key_tuple()))
    if correct_only:
        groups: List[List[SortingRead]] = [[r] for g in gs for r in g]
    else:
        groups = gs

    t1 = time.time()
    precomputed = _precompute_group_consensus(groups, ref_seqs,
                                              gap_call_threshold) \
        if not correct_only else {}
    t2 = time.time()

    # batch the singleton groups' alignment rates (one padded pass
    # instead of a numpy round trip per record)
    single_gis = [gi for gi, g in enumerate(groups) if len(g) == 1]
    single_rates: Dict[int, float] = {}
    if single_gis:
        rates = _batch_alignment_rates(
            [(groups[gi][0].reference_aligned, groups[gi][0].read_aligned)
             for gi in single_gis])
        single_rates = dict(zip(single_gis, rates))

    # record construction streams to an encode thread in chunks: the BAM
    # codec's C encode/deflate paths release the GIL, so BGZF compression
    # overlaps the remaining groups' consensus math (single consumer
    # thread = output order preserved)
    import queue
    import threading

    out_q: "queue.Queue" = queue.Queue(maxsize=4)
    errors: List[BaseException] = []

    def _encode_loop():
        while True:
            chunk = out_q.get()
            if chunk is None:
                return
            try:
                if hasattr(writer, "write_batch"):
                    writer.write_batch(chunk)
                else:
                    for rec in chunk:
                        writer.write(rec)
            except BaseException as exc:
                errors.append(exc)

    encoder = threading.Thread(target=_encode_loop, daemon=True)
    encoder.start()

    written = 0
    records = []
    try:
        for gi, group in enumerate(groups):
            rec = _consensus_record(group, ref_seqs,
                                    downsample_cap if not correct_only
                                    else 0, gap_call_threshold,
                                    precomputed.get(gi),
                                    rate=single_rates.get(gi))
            if rec is not None:
                records.append(rec)
                written += 1
            if len(records) >= 2048:
                if record_tap is not None:
                    record_tap.extend(records)
                out_q.put(records)
                records = []
        if record_tap is not None:
            record_tap.extend(records)
        out_q.put(records)
    finally:
        # always poison + join, even when a group's consensus raises:
        # a leaked encoder thread still holds the writer and can
        # interleave a mid-flight write_batch with the caller's cleanup
        out_q.put(None)
        t3 = time.time()
        encoder.join()
    if errors:
        raise errors[0]
    if phase_out is not None:
        phase_out["group_sort_s"] = round(t1 - t0, 3)
        phase_out["consensus_precompute_s"] = round(t2 - t1, 3)
        phase_out["record_loop_s"] = round(t3 - t2, 3)
        phase_out["encode_join_s"] = round(time.time() - t3, 3)
    return written


def _precompute_group_consensus(groups: List[List[SortingRead]],
                                ref_seqs: Dict[str, bytes],
                                gap_call_threshold: float,
                                chunk: int = 64) -> Dict[int, object]:
    """Batch eligible (multi-read, single-reference, insertion-free)
    groups' column consensus through consensus_fast_groups in chunks of
    ~64 groups: the segment-sum batch amortizes the ~25 numpy calls of
    per-group consensus_fast 64x while its [N, L] temporaries stay
    cache-resident (~600 rows x L). Measured 2x faster than per-group and
    12x faster than one whole-dataset batch (memory-bound) at bench group
    sizes. Returns {group index -> AlignmentResult} for
    _consensus_record's `precomputed` argument; ineligible groups keep
    the per-group paths."""
    from clique_tpu.consensus.fast import (
        consensus_fast_groups,
        group_is_insertion_free,
    )

    by_ref: Dict[str, List[int]] = {}
    for gi, group in enumerate(groups):
        if len(group) <= 1:
            continue
        rn = group[0].reference_name
        if any(r.reference_name != rn for r in group[1:]):
            continue
        ref_seq = ref_seqs.get(rn)
        if ref_seq is None or not group_is_insertion_free(
                ref_seq, [r.reference_aligned for r in group]):
            continue
        by_ref.setdefault(rn, []).append(gi)
    pre: Dict[int, object] = {}
    for rn, gis in by_ref.items():
        for lo in range(0, len(gis), chunk):
            part = gis[lo:lo + chunk]
            data = [([r.read_aligned for r in groups[gi]],
                     [r.read_quals for r in groups[gi]],
                     [r.read_name for r in groups[gi]]) for gi in part]
            outs = consensus_fast_groups(ref_seqs[rn], data, rn,
                                         gap_call_threshold)
            pre.update(zip(part, outs))
    return pre


def ref_seq_map(rm: ReferenceManager) -> Dict[str, bytes]:
    """Plain {name: sequence} view of a ReferenceManager - the picklable
    payload worker processes need for consensus building."""
    return {r.name: r.sequence for r in rm.references.values()}


def _batch_alignment_rates(pairs: List[Tuple[bytes, bytes]]) -> List[float]:
    """alignment_rate_fast over many (reference_aligned, read_aligned)
    pairs in one padded pass (padding bytes are 0 < 64: never counted)."""
    import numpy as np

    from clique_tpu.extract.extractor import alignment_rates_rows

    if not pairs:
        return []
    lens = [min(len(r), len(d)) for r, d in pairs]
    L = max(lens)
    x = np.zeros((len(pairs), L), dtype=np.uint8)
    y = np.zeros((len(pairs), L), dtype=np.uint8)
    for i, (r, d) in enumerate(pairs):
        n = lens[i]
        y[i, :n] = np.frombuffer(r[:n], dtype=np.uint8)
        x[i, :n] = np.frombuffer(d[:n], dtype=np.uint8)
    return [float(v) for v in alignment_rates_rows(y, x)]


def _consensus_record(group: List[SortingRead], ref_seqs: Dict[str, bytes],
                      downsample_cap: int, gap_call_threshold: float,
                      precomputed=None,
                      rate: Optional[float] = None) -> Optional[SamRecord]:
    """create_consensus_sam_read (consensus_builders.rs:174-286) +
    to_sam_record tag conventions."""
    tags: Dict[str, str] = {}
    tags["rc"] = str(len(group))
    tags["dc"] = str(min(downsample_cap, len(group)))

    if len(group) > 1:
        ref_name = Counter(
            r.reference_name for r in group).most_common(1)[0][0]
        ref_seq = ref_seqs[ref_name]
        from clique_tpu.consensus.fast import (
            consensus_fast,
            group_is_insertion_free,
        )

        if precomputed is not None:
            con = precomputed
        elif group_is_insertion_free(ref_seq,
                                     [r.reference_aligned for r in group]):
            con = consensus_fast(
                ref_seq, [r.read_aligned for r in group],
                [r.read_quals for r in group],
                [r.read_name for r in group], ref_name,
                gap_call_threshold)
        else:
            candidate = AlignmentCandidate(ref_seq, ref_name)
            failures = 0
            for r in group:
                try:
                    candidate.add_alignment(
                        r.reference_aligned, r.read_aligned,
                        r.read_name, r.read_quals)
                except ValueError:
                    failures += 1
            if failures > 1:
                raise RuntimeError(
                    f"Unable to create consensus for {len(group)} reads")
            con = candidate.to_consensus(gap_call_threshold)
        tags["ar"] = ",".join(r.read_name for r in group)
        con_rate = getattr(con, "alignment_rate", None)
        if con_rate is None:
            con_rate = alignment_rate_fast(con.reference_aligned,
                                           con.read_aligned)
        tags["rm"] = _fmt_rate(con_rate)
        tags["as"] = _fmt_rate(con.score)
        base = group[0]
        out_ref_aligned = con.reference_aligned
        out_read_aligned = con.read_aligned
        out_cigar = con.cigar
        read_name = base.read_name
        reference_start = 0
        sorting_keys = base.sorting_keys
    else:
        single = group[0]
        tags["ar"] = single.read_name
        if rate is None:
            rate = alignment_rate_fast(single.reference_aligned,
                                       single.read_aligned)
        tags["rm"] = _fmt_rate(rate)
        tags["as"] = _fmt_rate(single.score)
        out_ref_aligned = single.reference_aligned
        out_read_aligned = single.read_aligned
        out_cigar = single.cigar
        read_name = single.read_name
        reference_start = single.reference_start - 1 \
            if single.reference_start > 0 else 0
        sorting_keys = single.sorting_keys
        ref_name = single.reference_name

    for sym, original, corrected in sorting_keys:
        tags[f"e{sym}"] = corrected.decode()
        tags[f"o{sym}"] = original.decode()

    tags["rs"] = tags["as"]
    seq = out_read_aligned.replace(b"-", b"")   # gap strip (GAP == ord('-'))
    return SamRecord(
        name=read_name,
        flag=0,
        reference_name=ref_name,
        pos=reference_start + 1,
        mapq=255,
        cigar=out_cigar,
        seq=seq,
        qual=b"H" * len(seq),
        tags=tags,
    )


def _fmt_rate(x: float) -> str:
    if x != x:
        return "NaN"
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return repr(x)


def _checkpoint_path(temp_dir: str, ref_name: str, level: int) -> str:
    import os

    safe = "".join(c if c.isalnum() else "_" for c in ref_name)
    return os.path.join(temp_dir, f"collapse.{safe}.level{level}.ckpt")


# bumped whenever SortingRead's level-grouping state changes shape (v2:
# gid class ids) - a checkpoint from another format silently resuming
# would mis-group, so stale formats are discarded and the level re-runs
_CKPT_FORMAT = "clique-ckpt-v2"


def _save_checkpoint(path: str, reads: List[SortingRead]) -> None:
    import pickle

    with open(path + ".tmp", "wb") as fh:
        pickle.dump((_CKPT_FORMAT, reads), fh,
                    protocol=pickle.HIGHEST_PROTOCOL)
    import os

    os.replace(path + ".tmp", path)


def _load_checkpoint(path: str) -> Optional[List[SortingRead]]:
    import os
    import pickle

    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        payload = pickle.load(fh)
    if not (isinstance(payload, tuple) and len(payload) == 2
            and payload[0] == _CKPT_FORMAT):
        log.warning("discarding checkpoint %s (stale format)", path)
        return None
    return payload[1]


def collapse(*args, **kwargs) -> CollapseStats:
    """GC-controlled wrapper (see _collapse_impl for the pipeline and the
    full signature): ingest/levels hold millions of acyclic objects and
    cyclic-GC heap scans made them superlinear (utils/gcctl.py)."""
    from clique_tpu.utils.gcctl import hot_section

    with hot_section():
        return _collapse_impl(*args, **kwargs)


def _collapse_impl(output_path: str, layout: SequenceLayout, input_bam: str,
                   temp_dir: Optional[str] = None, correct_only: bool = False,
                   downsample_cap: int = 40,
                   metrics_path: Optional[str] = None,
                   checkpoint: bool = False,
                   out_of_core: bool = False,
                   n_workers: int = 1,
                   min_aligned_bases: int = 45,
                   min_identical: float = 0.8,
                   gap_call_threshold: float = 0.75,
                   shards: Optional[int] = None) -> CollapseStats:
    """The `clique collapse` equivalent (collapse.rs:70-141).

    n_workers > 1 runs the host-parallel in-RAM path (collapse/workers.py):
    spawned jax-free processes handle BAM decode/ingestion and consensus
    building while this process runs the device correction kernels — the
    answer here to the reference's rayon `--threads` fanout
    (alignment_functions.rs:90-93). With out_of_core (or caps/big BAMs
    forcing it), workers route through the shard-parallel streaming
    driver (collapse_parallel_spill); only checkpoint falls back to the
    single-process path.

    Also emits collapse_metrics.json (the reference README promises this,
    README.md:66-69, but never writes it): per-reference read accounting,
    per-level pass counts, and output record counts.

    With checkpoint=True (requires temp_dir), each correction level's
    output is persisted and an interrupted run resumes from the last
    completed level - the explicit version of the reference's implicit
    shardio temp files (SURVEY section 5 checkpoint/resume).

    out_of_core=True streams reads through hash-partitioned spill shards
    (collapse/shards.py) instead of RAM lists: only tag counters and
    correction maps stay resident - the shardio-equivalent path for runs
    that exceed memory (BASELINE config 5). Output records are identical
    to the in-RAM path but ordered by shard rather than global key sort."""
    import json
    import os
    import shutil
    import tempfile
    import time

    if n_workers and n_workers > 1 and not checkpoint:
        try:
            big = os.path.getsize(input_bam) > 4 << 30
        except OSError:
            big = False
        caps = any(cfg.maximum_subsequences is not None
                   for ref in layout.references.values()
                   for cfg in ref.umi_configurations.values())
        if big or caps or out_of_core:
            # workers + spill unified: the shard-parallel streaming
            # driver honors maximum_subsequences (O(1) per-bin residency)
            # while every stage still fans out over the pool
            from clique_tpu.collapse.workers import collapse_parallel_spill

            return collapse_parallel_spill(
                output_path, layout, input_bam, temp_dir=temp_dir,
                correct_only=correct_only, downsample_cap=downsample_cap,
                metrics_path=metrics_path, n_workers=n_workers,
                min_aligned_bases=min_aligned_bases,
                min_identical=min_identical,
                gap_call_threshold=gap_call_threshold, shards=shards)
        from clique_tpu.collapse.workers import collapse_parallel

        return collapse_parallel(
            output_path, layout, input_bam, temp_dir=temp_dir,
            correct_only=correct_only, downsample_cap=downsample_cap,
            metrics_path=metrics_path, n_workers=n_workers,
            min_aligned_bases=min_aligned_bases,
            min_identical=min_identical,
            gap_call_threshold=gap_call_threshold)

    rm = ReferenceManager.from_layout(layout)
    known_lists = load_known_lists(layout)
    references = [(r.name, len(r.sequence)) for r in rm.references.values()]
    writer = open_alignment_writer(output_path, references)
    stats = CollapseStats()
    metrics = {"input_bam": input_bam, "references": {},
               "started": time.time()}

    try:
        bam_bytes = os.path.getsize(input_bam)
    except OSError:
        bam_bytes = 0
    if not out_of_core:
        if bam_bytes > 4 << 30:
            # BGZF ~3-4x expands in RAM as SortingReads; beyond a few GB
            # the spill path is the safe default
            log.info("input BAM is %.1f GB; enabling out-of-core collapse",
                     bam_bytes / 2**30)
            out_of_core = True
        elif any(cfg.maximum_subsequences is not None
                 for ref in layout.references.values()
                 for cfg in ref.umi_configurations.values()):
            # maximum_subsequences caps per-bin RESIDENT reads (the
            # reference spills past the cap, never drops -
            # collapse.rs:884-888); the in-RAM path keeps everything
            # resident by construction, so honoring the cap means running
            # the streaming path, whose per-bin residency is O(1).
            # EXCEPTION: when the BAM's chunk index proves the whole file
            # holds fewer records than the smallest cap, no bin can ever
            # exceed it — the in-RAM path (global key-sorted output
            # order, same bytes as the fused chain) is then exact.
            from clique_tpu.io.sam import read_cqi

            min_cap = min(cfg.maximum_subsequences
                          for ref in layout.references.values()
                          for cfg in ref.umi_configurations.values()
                          if cfg.maximum_subsequences is not None)
            cqi = read_cqi(input_bam)
            total = cqi[-1][1] if cqi else None
            if total is not None and total <= min_cap:
                log.info("maximum_subsequences set but the BAM holds %d "
                         "records <= the smallest cap %d; the cap cannot "
                         "bind - staying in RAM", total, min_cap)
            else:
                log.info("maximum_subsequences set; enabling out-of-core "
                         "collapse to honor the per-bin resident cap")
                out_of_core = True

    spill_root = None
    n_shards = shards or 32
    if out_of_core:
        spill_root = tempfile.mkdtemp(prefix="clique_spill.", dir=temp_dir)
        # final consensus grouping materializes one shard at a time
        # (iter_sorted_groups); size shards so ~4x-expanded records stay
        # around <=256MB resident per shard
        if shards is None:
            n_shards = max(32, int(4 * bam_bytes / (256 << 20)) + 1)

    # ONE streaming pass over the input BAM routes every record to its
    # reference's ingestion state (the reference re-queries the indexed
    # BAM per reference, collapse.rs:437-491 - O(refs x filesize))
    from clique_tpu.collapse.shards import ShardWriter

    ingests: Dict[str, _RefIngest] = {}
    spill_dirs: Dict[str, str] = {}
    spill_writers: List[ShardWriter] = []
    for ref in rm.references.values():
        sw = None
        if out_of_core:
            safe = "".join(c if c.isalnum() else "_" for c in ref.name)
            level_dir = os.path.join(spill_root, f"{safe}.l0")
            sw = ShardWriter(level_dir, n_shards=n_shards)
            spill_dirs[ref.name] = level_dir
            spill_writers.append(sw)
        ingests[ref.name] = _RefIngest(
            ref.name, rm, layout, spill=sw,
            min_aligned_bases=min_aligned_bases,
            min_identical=min_identical)
    log.info("processing reads from input BAM file: %s "
             "(%d references, single pass)", input_bam, len(ingests))
    t_ingest = time.time()
    reads_by_ref = ingest_bam_single_pass(input_bam, ingests, stats)
    for sw in spill_writers:
        sw.close()
    metrics["ingest_s"] = round(time.time() - t_ingest, 3)
    t_levels = time.time()
    outputs_seconds = [0.0]

    for ref in rm.references.values():
        ing = ingests[ref.name]
        if out_of_core:
            safe = "".join(c if c.isalnum() else "_" for c in ref.name)
            level_dir = spill_dirs[ref.name]
            ref_metrics = {"passing_reads": ing.n_passing, "levels": []}
            if ing.n_passing == 0:
                log.warning("No valid reads found for reference %s",
                            ref.name)
                metrics["references"][ref.name] = ref_metrics
                continue
            configs = layout.get_sorted_umi_configurations(ref.name)
            for lvl, tag in enumerate(configs):
                next_dir = os.path.join(spill_root, f"{safe}.l{lvl + 1}")
                n_in, n_out = sort_level_spill(level_dir, tag, known_lists,
                                               next_dir, n_shards=n_shards)
                ref_metrics["levels"].append({
                    "symbol": tag.symbol, "sort_type": tag.sort_type.value,
                    "reads_in": n_in, "reads_out": n_out})
                shutil.rmtree(level_dir)
                level_dir = next_dir
            t_out = time.time()
            written = write_outputs_spill(level_dir, writer, rm,
                                          correct_only, downsample_cap,
                                          gap_call_threshold)
            outputs_seconds[0] += time.time() - t_out
            shutil.rmtree(level_dir)
            ref_metrics["output_records"] = written
            metrics["references"][ref.name] = ref_metrics
            log.info("reference %s: wrote %d records (out-of-core)",
                     ref.name, written)
            continue
        reads = reads_by_ref[ref.name]
        ref_metrics = {"passing_reads": ing.n_passing, "levels": []}
        metrics["references"][ref.name] = ref_metrics
        run_ref_levels_and_outputs(
            reads, ref.name, layout, rm, writer, known_lists, correct_only,
            downsample_cap, gap_call_threshold, ref_metrics,
            outputs_seconds,
            checkpoint_dir=temp_dir if checkpoint else None)

    writer.close()
    if spill_root is not None:
        shutil.rmtree(spill_root, ignore_errors=True)
    finish_collapse_metrics(metrics, stats, t_levels, outputs_seconds[0],
                            metrics_path, output_path)
    return stats


def run_ref_levels_and_outputs(reads: List[SortingRead], ref_name: str,
                               layout: SequenceLayout,
                               rm: ReferenceManager, writer,
                               known_lists, correct_only: bool,
                               downsample_cap: int,
                               gap_call_threshold: float,
                               ref_metrics: dict,
                               outputs_seconds: List[float],
                               checkpoint_dir: Optional[str] = None,
                               record_tap: Optional[list] = None,
                               log_suffix: str = "") -> int:
    """Per-reference in-RAM correction levels + consensus outputs — the
    single implementation behind collapse() and the fused chain's
    collapse_from_reads (their byte parity is pinned by
    tests/test_chain_fused.py). Appends per-level rows and output
    records/phases to ref_metrics; adds the outputs wall to
    outputs_seconds[0]."""
    if not reads:
        log.warning("No valid reads found for reference %s", ref_name)
        return 0
    configs = layout.get_sorted_umi_configurations(ref_name)
    start_level = 0
    if checkpoint_dir:
        # resume from the deepest completed level
        for lvl in range(len(configs), 0, -1):
            saved = _load_checkpoint(
                _checkpoint_path(checkpoint_dir, ref_name, lvl))
            if saved is not None:
                reads = saved
                start_level = lvl
                log.info("resumed reference %s from level %d "
                         "(%d reads)", ref_name, lvl, len(reads))
                break
    for lvl, tag in enumerate(configs):
        if lvl < start_level:
            continue
        n_in = len(reads)
        reads = sort_level(reads, tag, known_lists)
        ref_metrics["levels"].append({
            "symbol": tag.symbol, "sort_type": tag.sort_type.value,
            "reads_in": n_in, "reads_out": len(reads)})
        if checkpoint_dir:
            _save_checkpoint(
                _checkpoint_path(checkpoint_dir, ref_name, lvl + 1), reads)
    t_out = time.time()
    out_phases: dict = {}
    written = write_outputs(reads, writer, rm, correct_only,
                            downsample_cap, gap_call_threshold,
                            record_tap=record_tap, phase_out=out_phases)
    outputs_seconds[0] += time.time() - t_out
    ref_metrics["output_records"] = written
    ref_metrics["output_phases"] = out_phases
    log.info("reference %s: wrote %d records%s", ref_name, written,
             log_suffix)
    return written


def finish_collapse_metrics(metrics: dict, stats, t_levels: float,
                            outputs_s: float,
                            metrics_path: Optional[str],
                            output_path: str) -> None:
    """Shared metrics-JSON tail for collapse() / collapse_from_reads."""
    import json

    metrics["levels_s"] = round(time.time() - t_levels - outputs_s, 3)
    metrics["outputs_s"] = round(outputs_s, 3)
    metrics["elapsed_s"] = round(time.time() - metrics["started"], 3)
    metrics["read_stats"] = {
        "total": stats.total_reads, "unmapped": stats.unmapped,
        "secondary": stats.secondary, "failed_filters": stats.failed_filters,
        "invalid_tags": stats.invalid_tags, "passing": stats.passing}
    mpath = metrics_path or (str(output_path) + ".collapse_metrics.json")
    with open(mpath, "w") as fh:
        json.dump(metrics, fh, indent=2)
