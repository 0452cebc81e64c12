"""End-to-end `align` pipeline: FASTQ -> merge -> batched device DP ->
tag extraction -> tagged SAM/BAM.

A batched re-design of the reference align driver
(/root/reference/rust_cmd/src/alignment_functions.rs:63-257). Where the
reference runs one rayon thread per read with a thread-local DP matrix, we
stream reads into length buckets and run whole buckets through the batched
anti-diagonal kernel (align/batch.py) in one device dispatch; host work is
only FASTQ decoding, orientation votes, tag extraction, and SAM encoding.

Reference-selection semantics (align_to_reference_choices, :520-631):
- single reference: orient by longest shared segment when !known_strand,
  then global affine alignment. (The reference engine calls out to
  rust-bio with hardcoded 1/-1/-5/-1 scoring here and reports score 0.0;
  we run the same-scoring DP on device via the `ref_n_only` special rule.
  Set single_ref_native=True for the engine's own affine scoring instead.)
- multiple references: unique-kmer vote; if the top reference holds > 0.90
  of votes align to it, else exhaustively align against every candidate and
  keep the best score (quick/exhaustive_alignment_search, :693-827).

SAM tags written per read (:193-226 and alignment_matrix.rs:741-771):
e<sym> = extracted tag per UMI symbol, rc = 1, ar = read name,
rm = reference alignment rate, as/rs = alignment score.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from decimal import Decimal
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from clique_tpu.align import batch as dbatch
from clique_tpu.align.merge import MERGE_SCORING, alignment_rate_and_consensus, unify_read
from clique_tpu.align.scoring import AffineScoring
from clique_tpu.config.layout import (AlignedReadOrientation, MergeStrategy,
                                      SequenceLayout)
from clique_tpu.extract.extractor import (
    alignment_rate_fast,
    extract_digit_tags_fast,
    extract_tagged_sequences,
)
from clique_tpu.io.fastq import ReadIterator
from clique_tpu.io.sam import SamRecord, open_alignment_writer
from clique_tpu.reference.manager import ReferenceManager, orient_by_longest_segment
from clique_tpu.utils.seq import FASTA_N, GAP, reverse_complement

# read-chunk size for multi-host striping (align_reads read_shard): large
# enough that each process's device batches stay dense, small enough to
# balance 2+ processes on modest inputs (env-overridable for tests)
_SHARD_CHUNK = int(os.environ.get("CLIQUE_TPU_SHARD_CHUNK", "1024"))

log = logging.getLogger(__name__)

# rust-bio-compatible scoring used by the reference's single-reference path
# (alignment_functions.rs:48-61): match/ref-N = 1, mismatch = -1, gap -5/-1.
RUST_BIO_COMPAT = AffineScoring(1.0, -1.0, 1.0, -5.0, -1.0, 1.0)


def get_reference_alignment_rate(reference: bytes, read: bytes) -> float:
    """Identity over columns where both bytes are letters and the reference
    isn't N (consensus_builders.rs:288-307)."""
    matches = mismatches = 0
    for r, d in zip(reference, read):
        if r > 64 and r != FASTA_N and d > 64:
            if r == d:
                matches += 1
            else:
                mismatches += 1
    total = matches + mismatches
    return matches / total if total else float("nan")


@dataclass
class AlignedRead:
    """One aligned read ready for tag extraction / writing."""

    read_name: str
    reference_name: str
    reference_aligned: bytes
    read_aligned: bytes
    quals: Optional[bytes]
    cigar: List[Tuple[int, str]]
    score: float
    reference_start: int = 0

    def to_sam_record(self, extra_tags: Dict[str, str]) -> SamRecord:
        """AlignmentResult::to_sam_record (alignment_matrix.rs:741-771):
        gap-stripped sequence, qual hardcoded 'H', pos = start+1, tags
        rm/rs/ar/as + extras."""
        arr = np.frombuffer(self.read_aligned, dtype=np.uint8)
        seq = arr[arr != GAP].tobytes()
        tags = dict(extra_tags)
        tags["rm"] = _fmt(alignment_rate_fast(
            self.reference_aligned, self.read_aligned))
        tags["rs"] = _fmt(self.score)
        tags["as"] = _fmt(self.score)
        return SamRecord(
            name=self.read_name,
            flag=0,
            reference_name=self.reference_name,
            pos=self.reference_start + 1,
            mapq=255,
            cigar=list(self.cigar),
            seq=seq,
            qual=b"H" * len(seq),
            tags=tags,
        )


def _fmt(x: float) -> str:
    """Render a float exactly as Rust's f64 `Display` does (used for the
    rm/as SAM tags, reference alignment_matrix.rs:741-771).

    Rust Display prints the shortest decimal that round-trips and NEVER
    uses scientific notation: 290.0 -> "290", 1e16 -> "10000000000000000",
    1.5e-7 -> "0.00000015", -0.0 -> "-0". Python `repr` matches the
    shortest-round-trip digits but switches to exponent form outside
    ~[1e-4, 1e16); expand those through Decimal (exact, since Decimal is
    constructed from repr's digit string, not the binary float)."""
    if x != x:  # NaN
        return "NaN"
    if x == float("inf"):
        return "inf"
    if x == float("-inf"):
        return "-inf"
    s = repr(x)
    if s.endswith(".0"):
        return s[:-2]  # 290.0 -> "290", -0.0 -> "-0"
    if "e" not in s and "E" not in s:
        return s
    return format(Decimal(s), "f")


@dataclass
class _Pending:
    name: str
    seq: bytes
    quals: bytes
    ref_id: int


class BatchAligner:
    """Length-bucketed batcher around align_batch_device."""

    def __init__(self, scoring: AffineScoring, batch_size: int = 128,
                 length_quantum: int = 128, special_mode: str = "both",
                 use_mesh: Optional[bool] = None,
                 bandwidth: Optional[int] = None, fill: str = "auto"):
        self.params = dbatch.scoring_to_params(scoring)
        self.batch_size = batch_size
        self.quantum = length_quantum
        self.special_mode = special_mode
        # Partial band (perform_affine_alignment_bandwidth,
        # alignment_matrix.rs:376-425): half-width around the f64 band
        # centers. None = full band (what every reference call site passes:
        # max_indel = read length, alignment_functions.rs:383-449). The
        # CUDA fill is full-band only, so a partial band routes through
        # the XLA scan fill.
        self.bandwidth = bandwidth
        # "auto": each dispatch takes dbatch.select_fill's choice (the CUDA
        # kernel on a GPU, the XLA scan elsewhere); "scan" keeps the XLA
        # scan on every backend (the kernel-vs-scan comparison)
        if fill not in ("auto", "scan"):
            raise ValueError(f"fill must be 'auto' or 'scan', not {fill!r}")
        self.fill = fill
        # wave width: how many same-shape groups fuse into one scan
        # dispatch (align_pairs_raw). Default 1 (off); not yet measured
        # on the H100
        self.wave = int(os.environ.get("CLIQUE_TPU_WAVE", "1"))
        # fetch-fuse width: how many same-shape dispatched groups get
        # their FUSED RESULT BUFFERS concatenated on device into one
        # pulled array. Unlike the wave (which fuses the compute into one
        # serial lax.scan), dispatches stay separate — only the
        # device->host result transfer fuses, so K groups cost one pull.
        self.fetch_fuse = int(os.environ.get("CLIQUE_TPU_FETCH_FUSE", "1"))
        self._compiled_b: Dict[Tuple[int, int], int] = {}
        self.device_seconds = 0.0   # dispatch + sync time
        self.post_seconds = 0.0     # host-side expansion
        # dispatch runs on the main thread while pulls/expansion run on
        # the drain thread: the timing counters need a lock or the
        # unsynchronized += interleaves and drops increments
        import threading

        self._t_lock = threading.Lock()
        self.pairs_aligned = 0
        self.cells_filled = 0

        # shard batches over all devices when more than one is visible: read
        # batches data-parallel, scoring params replicated (SURVEY 2.11 P1)
        import jax

        self.backend = jax.default_backend()
        self.mesh = None
        # under jax.distributed (multi-host align) each process aligns its
        # own FASTQ stripe: data parallelism across processes happens at
        # the stripe level (align_reads read_shard), so the batch mesh
        # must span only LOCAL devices — a global mesh would make
        # device_put demand identical batches on every process
        devices = jax.local_devices() if jax.process_count() > 1 \
            else jax.devices()
        n_dev = len(devices)
        if use_mesh is None:
            use_mesh = n_dev > 1
        if use_mesh and n_dev > 1:
            from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

            self.mesh = Mesh(np.array(devices), axis_names=("data",))
            self._data_sharding = NamedSharding(self.mesh, P("data"))
            self._repl_sharding = NamedSharding(self.mesh, P())
            self.params = jax.device_put(self.params, self._repl_sharding)
            # the CUDA fill stays on under a mesh: align_batch_device
            # wraps it in shard_map over "data" (XLA cannot partition a
            # custom call itself)

    def _fill_for(self, n1: int, batch: int) -> str:
        """The fill for one dispatch of `batch` rows and n1 DP rows."""
        if self.fill == "scan":
            return "scan"
        return dbatch.select_fill(
            self.backend, n1=n1, batch=batch,
            banded=self.bandwidth is not None,
            mesh_size=1 if self.mesh is None else self.mesh.size)

    def _bucket_len(self, n: int) -> int:
        q = self.quantum
        return max(q, -(-n // q) * q)

    def align_pairs_entries(self, refs: List[bytes], reads: List[bytes]):
        """Dispatch + pull WITHOUT host expansion: returns pulled entries
        (group/wave metadata + the fused result bytes) for expand_entry.
        The align_reads writer thread expands them off the critical path;
        align_pairs_raw expands inline for everyone else.

        All device dispatches go out before any result is pulled back
        (JAX dispatch is async), so transfers overlap compute."""
        import jax

        i = 0
        # precompute each pair's bucket shape once (the per-call lambda
        # re-derived it ~4x per read — ~0.1s per 20k reads)
        shapes = [(self._bucket_len(len(refs[k]) + 1),
                   self._bucket_len(len(reads[k]) + 1))
                  for k in range(len(refs))]
        idxs = sorted(range(len(refs)), key=shapes.__getitem__)
        t0 = time.time()
        buckets = []
        while i < len(idxs):
            n1, n2 = shapes[idxs[i]]
            group = []
            while i < len(idxs) and len(group) < self.batch_size and \
                    shapes[idxs[i]] == (n1, n2):
                group.append(idxs[i])
                i += 1
            buckets.append((group, n1, n2))
            self.cells_filled += len(group) * (n1 - 1) * (n2 - 1)
        self.pairs_aligned += len(idxs)

        # coalesce runs of same-shape uniform-reference groups into waves:
        # ONE scan-dispatch covers up to self.wave groups (one dispatch +
        # one pull instead of W of each)
        inflight = []
        j = 0
        while j < len(buckets):
            group, n1, n2 = buckets[j]
            run = 1
            if self.wave > 1 and self.bandwidth is None:
                r0 = refs[group[0]]
                while (run < self.wave and j + run < len(buckets)
                       and buckets[j + run][1] == n1
                       and buckets[j + run][2] == n2):
                    run += 1
                uniform = all(refs[k] is r0
                              for jj in range(j, j + run)
                              for k in buckets[jj][0])
                if run > 1 and uniform:
                    inflight.append(self._dispatch_wave(
                        [buckets[jj][0] for jj in range(j, j + run)],
                        refs, reads, n1, n2))
                    j += run
                    continue
            inflight.append(self._dispatch_group(group, refs, reads, n1, n2))
            j += 1

        # fetch-fuse packs: concatenate consecutive same-shape "single"
        # entries' fused result buffers on device so K groups cost one
        # result pull (per-array fetch latency is the drain floor).
        # Compute already happened in the K separate dispatches above;
        # the concat is one tiny device op per pack.
        packs: List = []
        if self.fetch_fuse > 1:
            p = 0
            while p < len(inflight):
                e = inflight[p]
                run = [e]
                if e[0] == "single":
                    shape = e[-1].shape
                    while (len(run) < self.fetch_fuse
                           and p + len(run) < len(inflight)
                           and inflight[p + len(run)][0] == "single"
                           and inflight[p + len(run)][-1].shape == shape):
                        run.append(inflight[p + len(run)])
                buf = dbatch.concat_fused(*[x[-1] for x in run]) \
                    if len(run) > 1 else e[-1]
                packs.append((run, buf))
                p += len(run)
        else:
            packs = [([e], e[-1]) for e in inflight]

        # start every device->host copy before blocking on any, so the
        # copies overlap. Each entry carries ONE fused result buffer
        # (fuse_result): one pull per dispatch instead of three.
        for _run, buf in packs:
            try:
                buf.copy_to_host_async()
            except Exception:
                pass

        with self._t_lock:
            self.device_seconds += time.time() - t0

        def pulls():
            # lazy per-pack pulls: align_pairs_raw expands one entry
            # while the next async copy completes
            for run, buf in packs:
                t1 = time.time()
                fused_np = np.asarray(jax.device_get(buf))
                dt = time.time() - t1
                with self._t_lock:
                    self.device_seconds += dt
                if len(run) == 1:
                    yield run[0][:-1] + (fused_np,)
                    continue
                off = 0
                for entry in run:
                    b = entry[-1].shape[0]
                    yield entry[:-1] + (fused_np[off:off + b],)
                    off += b
        return pulls()

    def expand_entry(self, entry):
        """Expand one pulled entry (align_pairs_entries) into per-group
        raw tuples (group, a_ref, a_read, valid, ops, n_ops, scores).
        Pure host numpy — safe to run on the writer thread so expansion
        overlaps the next chunk's parse + dispatch."""
        t1 = time.time()
        out = []

        def expand(group, packed, n_ops, scores, refs_host, reads_host):
            # trim to real rows and to the batch's longest op sequence:
            # T is padded to the worst case n1+n2-1, but typical
            # alignments use ~half — halves every expansion pass
            g = len(group)
            n_o = n_ops[:g]
            P = max(1, (int(n_o.max(initial=0)) + 3) // 4)
            ops = dbatch.unpack_ops(packed[:g, :P], P * 4)
            a_ref, a_read, valid = dbatch.ops_to_alignments_batch(
                ops, n_o, refs_host[:g], reads_host[:g])
            out.append((group, a_ref, a_read, valid, ops, n_o,
                        scores[:g]))

        if entry[0] == "wave":
            _tag, groups_run, refs_host, reads_w, T, fused = entry
            packed_w, n_ops_w, scores_w = dbatch.unfuse_result(fused)
            for w, group in enumerate(groups_run):
                expand(group, packed_w[w], n_ops_w[w], scores_w[w],
                       refs_host, reads_w[w])
        else:
            _tag, group, refs_arr, reads_arr, T, fused = entry
            packed, n_ops, scores = dbatch.unfuse_result(fused)
            expand(group, packed, n_ops, scores, refs_arr, reads_arr)
        dt = time.time() - t1
        with self._t_lock:
            self.post_seconds += dt
        return out

    def align_pairs_raw(self, refs: List[bytes], reads: List[bytes]):
        """Expanded view of align_pairs_entries (see expand_entry)."""
        out = []
        for entry in self.align_pairs_entries(refs, reads):
            out.extend(self.expand_entry(entry))
        return out

    def align_pairs(self, refs: List[bytes], reads: List[bytes]
                    ) -> List[Tuple[bytes, bytes, List[Tuple[int, str]], float]]:
        """Per-pair (ref_aligned, read_aligned, cigar, score) view of
        align_pairs_raw, in input order."""
        results: List = [None] * len(refs)
        for group, a_ref, a_read, _valid, ops, n_ops, scores in \
                self.align_pairs_raw(refs, reads):
            t1 = time.time()
            cigars = dbatch.cigars_from_ops_batch(ops, n_ops)
            for j, k in enumerate(group):
                n = int(n_ops[j])
                results[k] = (a_ref[j, :n].tobytes(),
                              a_read[j, :n].tobytes(),
                              cigars[j],
                              float(scores[j]))
            dt = time.time() - t1
            with self._t_lock:
                self.post_seconds += dt
        return results

    def _dispatch_group(self, group, refs, reads, n1, n2):
        import jax

        # pad the batch dimension to a power of two (min 32) so each (B, n1,
        # n2) kernel shape is compiled once and reused; once a bigger shape
        # has compiled for this (n1, n2), pad smaller (remainder) batches up
        # to it instead of compiling another variant
        B = 32
        while B < len(group):
            B *= 2
        key = (n1, n2)
        prev = self._compiled_b.get(key, 0)
        if B < prev:
            B = prev
        else:
            self._compiled_b[key] = B
        r0 = refs[group[0]]
        uniform_ref = all(refs[k] is r0 for k in group)
        refs_arr = np.zeros((B, n1 - 1), dtype=np.uint8)
        reads_arr = np.zeros((B, n2 - 1), dtype=np.uint8)
        ref_lens = np.zeros(B, dtype=np.int32)
        read_lens = np.zeros(B, dtype=np.int32)
        g = len(group)
        d0 = len(reads[group[0]])
        if uniform_ref and all(len(reads[k]) == d0 for k in group):
            # equal-length batch (the fixed-layout amplicon hot path):
            # one C-speed join + reshape instead of a per-read copy loop
            refs_arr[:g, :len(r0)] = np.frombuffer(r0, dtype=np.uint8)
            reads_arr[:g, :d0] = np.frombuffer(
                b"".join(reads[k] for k in group),
                dtype=np.uint8).reshape(g, d0)
            ref_lens[:g] = len(r0)
            read_lens[:g] = d0
        else:
            for j, k in enumerate(group):
                r, d = refs[k], reads[k]
                refs_arr[j, :len(r)] = np.frombuffer(r, dtype=np.uint8)
                reads_arr[j, :len(d)] = np.frombuffer(d, dtype=np.uint8)
                ref_lens[j] = len(r)
                read_lens[j] = len(d)
        # uniform-reference batch (the single-amplicon hot path): ship ONE
        # reference row; align_batch_device broadcasts it on device, so the
        # host->device payload nearly halves
        dev_refs = refs_arr[:1] if uniform_ref else refs_arr
        bw = np.maximum(ref_lens, np.maximum(read_lens, 1))
        band_centers = None
        fill = self._fill_for(n1, B)
        if self.bandwidth is not None:
            bw = np.minimum(bw, np.int32(self.bandwidth))
            band_centers = dbatch.band_centers_f64(ref_lens, read_lens, n1)
        args = (dev_refs, reads_arr, ref_lens, read_lens, bw)
        mesh_arg = None
        if self.mesh is not None:
            # a single-row uniform reference replicates; batch args shard
            ref_sharding = self._repl_sharding if uniform_ref \
                else self._data_sharding
            args = (jax.device_put(dev_refs, ref_sharding),) + tuple(
                jax.device_put(a, self._data_sharding) for a in args[1:])
            if band_centers is not None:
                band_centers = jax.device_put(band_centers,
                                              self._data_sharding)
            if fill == "cuda":
                mesh_arg = self.mesh
        res, _tb = dbatch.align_batch_device(
            *args, self.params,
            n1=n1, n2=n2, special_mode=self.special_mode,
            fill=fill, return_traceback=False,
            band_centers=band_centers, mesh=mesh_arg)
        fused = dbatch.fuse_result(res.ops_packed, res.n_ops, res.score)
        return "single", group, refs_arr, reads_arr, int(res.ops.shape[-1]), \
            fused

    def _dispatch_wave(self, groups: List[List[int]], refs, reads, n1, n2):
        """One device call for a run of same-shape groups sharing ONE
        reference object (the single-amplicon hot path): stack reads
        [W, B, n2-1], ship the reference once, and lax.scan the fill+walk
        over the wave axis (dbatch.align_batch_device_wave). The run pads
        up to self.wave with empty groups so exactly one (W, B, n1, n2)
        variant ever compiles; empty rows cost one zero-length fill."""
        import jax

        W = self.wave
        B = 32
        while B < max(len(g) for g in groups):
            B *= 2
        key = (n1, n2)
        prev = self._compiled_b.get(key, 0)
        if B < prev:
            B = prev
        else:
            self._compiled_b[key] = B

        r0 = refs[groups[0][0]]
        ref_row = np.zeros((1, n1 - 1), dtype=np.uint8)
        ref_row[0, :len(r0)] = np.frombuffer(r0, dtype=np.uint8)
        reads_w = np.zeros((W, B, n2 - 1), dtype=np.uint8)
        ref_lens = np.zeros((W, B), dtype=np.int32)
        read_lens = np.zeros((W, B), dtype=np.int32)
        for w, group in enumerate(groups):
            for j, k in enumerate(group):
                d = reads[k]
                reads_w[w, j, :len(d)] = np.frombuffer(d, dtype=np.uint8)
                ref_lens[w, j] = len(refs[k])
                read_lens[w, j] = len(d)
        bw = np.maximum(ref_lens, np.maximum(read_lens, 1))
        # host-side reference matrix for post-processing (never shipped)
        refs_host = np.broadcast_to(ref_row, (B, n1 - 1))

        fill = self._fill_for(n1, B)
        args = (reads_w, ref_lens, read_lens, bw)
        mesh_arg = None
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            # wave axis stays whole; batch axis shards over the mesh
            wave_sharding = NamedSharding(self.mesh, P(None, "data"))
            args = tuple(jax.device_put(a, wave_sharding) for a in args)
            if fill == "cuda":
                mesh_arg = self.mesh
        res = dbatch.align_batch_device_wave(
            ref_row, *args, self.params, n1=n1, n2=n2,
            special_mode=self.special_mode, fill=fill,
            mesh=mesh_arg)
        fused = dbatch.fuse_result(res.ops_packed, res.n_ops, res.score)
        return "wave", groups, refs_host, reads_w, int(res.ops.shape[-1]), \
            fused


@dataclass
class AlignStats:
    total: int = 0
    aligned: int = 0
    dropped_length: int = 0
    dropped_short: int = 0
    failed: int = 0


def align_reads(*args, **kwargs) -> AlignStats:
    """GC-controlled wrapper (see _align_reads_impl for the pipeline and
    the full signature): the align stage allocates millions of acyclic
    record objects, and cyclic-GC heap scans made it superlinear in
    dataset size (utils/gcctl.py)."""
    from clique_tpu.utils.gcctl import hot_section

    with hot_section():
        return _align_reads_impl(*args, **kwargs)


def _align_reads_impl(
    layout: SequenceLayout,
    rm: ReferenceManager,
    output_path: str,
    read1: str,
    read2: Optional[str] = None,
    index1: Optional[str] = None,
    index2: Optional[str] = None,
    max_reference_multiplier: int = 2,
    min_read_length: int = 50,
    batch_size: int = 256,
    scoring: Optional[AffineScoring] = None,
    single_ref_native: bool = False,
    quick_match_threshold: float = 0.90,
    mode: str = "ont",
    router: str = "kmer",
    engine: Optional[str] = None,
    anchored_min_length: int = 2048,
    metrics_path: Optional[str] = None,
    pipeline_threads: bool = True,
    profile_dir: Optional[str] = None,
    bandwidth: Optional[int] = None,
    read_shard: Optional[Tuple[int, int]] = None,
    sink=None,
    fill: str = "auto",
    use_mesh: Optional[bool] = None,
) -> AlignStats:
    """The `clique align` equivalent (alignment_functions.rs:63-257).

    mode: "ont" (reference-compatible scoring) or "hifi" (PacBio low-error
    preset, BASELINE config 2). router: "kmer" (unique-kmer vote, the
    reference's quick_alignment_search) or "hmm" (pair-HMM forward routing,
    the north-star multi-amplicon router).

    anchored_min_length: reads at least this long (and passing the
    max_reference_multiplier gate) route through the anchored
    seed-and-extend path on the DP engine: exact anchors on host, the
    inter-anchor sub-DPs batched on device (linked_alignment.rs:147-266
    wiring the reference leaves unused; align/anchored.py).

    engine: "dp" (exact 3-plane affine DP - reference-parity default),
    "wfa" (wavefront engine with traceback, align/wavefront.py), or
    "convex" (the same wavefront engine under the dual-affine/"convex"
    penalty model, WFA2-lib's affine2p — wavefront_compute_affine2p.o,
    SURVEY 2.9: long gaps pay min(o1+n*e1, o2+n*e2)). The reference
    parses --aligner=wfa but never uses it (main.rs:127-133,
    alignment_functions.rs:74). The default for every mode is "dp" (see
    below); the WFA engines are opt-in
    where their O(ns) bound or penalty models matter. Scores on the WFA
    path are negated penalties, and the multi-reference exhaustive
    search ranks candidates by minimal penalty (last-minimum tie order,
    matching the last-maximum Rust max_by quirk).

    read_shard: (rank, world) — process only the read chunks dealt to this
    rank (chunks of _SHARD_CHUNK read sets, round-robin by chunk index:
    a deterministic disjoint cover). The multi-host align driver
    (parallel/distributed.py:align_distributed) gives each process one
    shard and merges the per-process part BAMs; stats then cover the
    LOCAL slice only.

    sink: optional CollapseSink (clique_tpu/chain.py) — a tap on the
    writer stream receiving every aligned result in BAM write order, so
    a fused chain ingests collapse input without re-parsing the BAM.

    fill, use_mesh: passed to every BatchAligner ("scan" keeps the XLA
    scan fill on a GPU; use_mesh=False keeps batches on one device)."""
    if engine is None:
        # default engine for EVERY mode is the exact 3-plane DP: the
        # batched fill is data-parallel across a whole read batch while
        # WFA's score loop is sequential (the dp-vs-wfa speed at amplicon
        # lengths is not yet measured on the H100). WFA remains the
        # opt-in engine (--engine wfa/convex) where its O(ns) bound or
        # penalty models matter (long reads, structural variants).
        engine = "dp"
    if scoring is None:
        scoring = AffineScoring.hifi_default() if mode == "hifi" \
            else AffineScoring.aligner_default()
    hmm_router = None
    if router == "hmm" and len(rm.references) > 1:
        from clique_tpu.align.hmm import HmmRouter

        hmm_router = HmmRouter([r.sequence for r in rm.references.values()])
    stats = AlignStats()
    # flush granularity: batches accumulated before a device flush. Lower
    # factors shrink the FINAL flush's exposed fetch tail at EOF but cost
    # more dispatch/pull round trips per run; 8 is not yet measured on
    # the H100.
    flush_factor = int(os.environ.get("CLIQUE_TPU_FLUSH_FACTOR", "8"))
    max_read_size = (rm.longest_ref + 1) * max_reference_multiplier
    single_ref = len(rm.references) == 1

    if single_ref and not single_ref_native and engine not in ("wfa",
                                                               "convex"):
        aligner = BatchAligner(RUST_BIO_COMPAT, batch_size,
                               special_mode="ref_n_only",
                               bandwidth=bandwidth, fill=fill,
                               use_mesh=use_mesh)
        report_zero_score = True   # the reference reports 0.0 here (:579)
    else:
        aligner = BatchAligner(scoring, batch_size, bandwidth=bandwidth,
                               fill=fill, use_mesh=use_mesh)
        report_zero_score = False
    if engine in ("wfa", "convex"):
        from clique_tpu.align.wavefront import WfaAligner

        aligner = WfaAligner(
            batch_size=batch_size, dp_fallback=aligner,
            model="affine2p" if engine == "convex" else "affine")
    merge_aligner = BatchAligner(MERGE_SCORING, batch_size, fill=fill,
                                 use_mesh=use_mesh)

    profiler_cm = None
    if profile_dir:
        import jax

        profiler_cm = jax.profiler.trace(profile_dir)
        profiler_cm.__enter__()

    references = [(r.name, len(r.sequence)) for r in rm.references.values()]
    writer = open_alignment_writer(output_path, references)
    start = time.time()

    # wall-clock phase accounting (written to metrics JSON): where the
    # align stage's non-device time goes on the main thread, plus busy
    # time of the build/writer pipeline threads
    phase = {"reader_wall": 0.0, "flush_wall": 0.0, "drain_wall": 0.0,
             "tail_wall": 0.0, "join_wall": 0.0}

    # two-stage writer pipeline: a BUILD thread does record construction
    # + sink ingestion (numpy-heavy), feeding a WRITER thread doing BAM
    # encode + BGZF compression (C paths that release the GIL). Both
    # overlap the main thread's parse/dispatch, and splitting them halves
    # the post-loop drain (join_wall): construction of flush N overlaps
    # compression of flush N-1 instead of serializing on one thread.
    import queue
    import threading

    write_queue: "queue.Queue" = queue.Queue(maxsize=8)
    encode_queue: "queue.Queue" = queue.Queue(maxsize=8)
    writer_error: List[BaseException] = []
    bam_ref_idx = {rid: i for i, rid in enumerate(rm.references.keys())}
    writer_encoded_ok = hasattr(writer, "write_encoded")

    # sink ingestion on its own thread: CollapseSink.consume_* is ~0.8s
    # of per-read python at 80k reads and was serializing inside the
    # build thread (the pipeline's straggler). A FIFO queue preserves
    # BAM write order, so ordinals and group member order are unchanged;
    # the sink's state is touched only by this thread until the join.
    # CLIQUE_TPU_SINK_THREAD=0 restores inline consumption.
    sink_queue: "Optional[queue.Queue]" = None
    sink_thread = None

    def _sink_loop():
        while True:
            item = sink_queue.get()
            if item is None:
                return
            t_s = time.time()
            try:
                if item[0] == "flush":
                    _t, raws_, pend_, recs_, caps_, cig_, slen_ = item
                    sink.consume_flush(raws_, pend_, recs_, caps=caps_,
                                       cigars_by_k=cig_,
                                       seq_len_by_k=slen_)
                else:          # ("aligned", aligned_out, recs)
                    sink.consume_aligned(item[1], item[2])
            except BaseException as exc:  # surfaced on close
                writer_error.append(exc)
            phase["sink_busy"] = phase.get("sink_busy", 0.0) + \
                (time.time() - t_s)

    def _sink_flush(raws, pend, recs, caps=None, cigars_by_k=None,
                    seq_len_by_k=None):
        if sink_queue is not None:
            sink_queue.put(("flush", raws, pend, recs, caps, cigars_by_k,
                            seq_len_by_k))
        else:
            sink.consume_flush(raws, pend, recs, caps=caps,
                               cigars_by_k=cigars_by_k,
                               seq_len_by_k=seq_len_by_k)

    def _sink_aligned(aligned_out, recs):
        if sink_queue is not None:
            sink_queue.put(("aligned", aligned_out, recs))
        else:
            sink.consume_aligned(aligned_out, recs)

    def _build_loop():
        while True:
            item = write_queue.get()
            if item is None:
                encode_queue.put(None)
                return
            t_b = time.time()
            try:
                if isinstance(item, tuple) and item and item[0] == "raw":
                    # deferred record construction, two forms. Fast path:
                    # the native assembler builds the flush's BAM record
                    # bytes straight from the batch blobs (no SamRecord
                    # objects / tags dicts / per-record encode loop —
                    # that python round trip was ~40% of the writer
                    # pipeline's GIL time). Falls back to per-record
                    # python construction for extractor-zone symbols,
                    # mixed symbol orders, or no C compiler.
                    _tag, raws, pend = item
                    fast = None
                    if writer_encoded_ok:
                        syms = _flush_fastpath_syms(pend, layout, rm)
                        if syms is not None:
                            fast = _encode_flush_fastpath(
                                raws, pend, layout, rm, report_zero_score,
                                bam_ref_idx, syms)
                    if fast is not None:
                        data, caps_g, cig_by_k, slen_by_k = fast
                        if sink is not None:
                            _sink_flush(raws, pend, None, caps=caps_g,
                                        cigars_by_k=cig_by_k,
                                        seq_len_by_k=slen_by_k)
                        phase["build_busy"] = \
                            phase.get("build_busy", 0.0) + \
                            (time.time() - t_b)
                        encode_queue.put(("encoded", data, len(pend)))
                        continue
                    recs: List = [None] * len(pend)
                    caps: List = [] if sink is not None else None
                    for raw in raws:
                        _fill_records_from_raw(raw, pend, recs, layout,
                                               rm, report_zero_score,
                                               out_caps=caps)
                    if sink is not None:
                        _sink_flush(raws, pend, recs, caps=caps)
                    item = recs
                elif isinstance(item, tuple) and item and \
                        item[0] == "aligned":
                    # deferred per-read record construction (WFA /
                    # anchored engine outputs)
                    recs = [_make_record(alr, layout) for alr in item[1]]
                    if sink is not None:
                        _sink_aligned(item[1], recs)
                    item = recs
            except BaseException as exc:  # surfaced on close
                writer_error.append(exc)
                item = []
            phase["build_busy"] = phase.get("build_busy", 0.0) + \
                (time.time() - t_b)
            encode_queue.put(item)

    def _writer_loop():
        while True:
            item = encode_queue.get()
            if item is None:
                return
            t_w = time.time()
            try:
                if isinstance(item, tuple) and item and \
                        item[0] == "encoded":
                    writer.write_encoded(item[1], item[2])
                elif hasattr(writer, "write_batch"):
                    writer.write_batch(item)
                else:
                    for rec in item:
                        writer.write(rec)
            except BaseException as exc:  # surfaced on close
                writer_error.append(exc)
            phase["write_busy"] = phase.get("write_busy", 0.0) + \
                (time.time() - t_w)

    # third pipeline stage: a DRAIN thread pulls device results and runs
    # the numpy expansion (expand_entry) off the main thread. At 80k
    # reads the main thread's drain work (fetch waits + expansion) is a
    # large align-wall term while the build/writer threads have spare
    # cores — moving it here overlaps expansion with the next chunk's
    # parse + dispatch. A single FIFO
    # queue preserves output record order; maxsize bounds undrained
    # flushes (device result buffers in flight). CLIQUE_TPU_DRAIN_THREAD=0
    # restores the round-4 deferred-drain-on-main-thread behavior.
    drain_queue: "Optional[queue.Queue]" = None
    drain_thread = None

    def _expand_and_enqueue(entries, pend):
        """The one definition of the drain protocol (used by the drain
        thread AND the deferred-drain fallback): pull+expand every entry
        of a flush, forward one ('raw', raws, pend) to the build stage."""
        raws = []
        for entry in entries:
            raws.extend(aligner.expand_entry(entry))
        write_queue.put(("raw", raws, pend))

    def _drain_loop():
        while True:
            item = drain_queue.get()
            if item is None:
                write_queue.put(None)
                return
            t_d = time.time()
            try:
                if item[0] == "entries":
                    _tag, entries, pend = item
                    _expand_and_enqueue(entries, pend)
                else:          # ("fwd", payload): ordered passthrough
                    write_queue.put(item[1])
            except BaseException as exc:  # surfaced on close
                writer_error.append(exc)
            phase["drain_busy"] = phase.get("drain_busy", 0.0) + \
                (time.time() - t_d)

    writer_thread = None
    build_thread = None
    if pipeline_threads:
        build_thread = threading.Thread(target=_build_loop, daemon=True)
        build_thread.start()
        writer_thread = threading.Thread(target=_writer_loop, daemon=True)
        writer_thread.start()
        if os.environ.get("CLIQUE_TPU_DRAIN_THREAD", "1") == "1":
            drain_queue = queue.Queue(maxsize=4)
            drain_thread = threading.Thread(target=_drain_loop, daemon=True)
            drain_thread.start()
        # default ON (not yet measured against inline consumption on
        # the H100)
        if sink is not None and \
                os.environ.get("CLIQUE_TPU_SINK_THREAD", "1") == "1":
            sink_queue = queue.Queue(maxsize=8)
            sink_thread = threading.Thread(target=_sink_loop, daemon=True)
            sink_thread.start()

    def emit_records(records):
        # any non-deferred emission must first drain deferred fast-path
        # flushes so output record order stays input order (with the
        # drain thread, order is preserved by routing through its queue)
        drain_deferred()
        if drain_queue is not None:
            drain_queue.put(("fwd", records))
        elif writer_thread is not None:
            write_queue.put(records)
        elif hasattr(writer, "write_batch"):
            writer.write_batch(records)
        else:
            for rec in records:
                writer.write(rec)

    def emit_aligned(aligned_out):
        """Emit AlignedReads; record construction defers to the writer
        thread when one is running so it overlaps the next batch."""
        drain_deferred()
        if drain_queue is not None:
            drain_queue.put(("fwd", ("aligned", aligned_out)))
        elif writer_thread is not None:
            write_queue.put(("aligned", aligned_out))
        else:
            recs = [_make_record(alr, layout) for alr in aligned_out]
            if sink is not None:
                sink.consume_aligned(aligned_out, recs)
            emit_records(recs)

    # deferred fast-path flushes: [(entries generator, pending copy)] —
    # drained one flush behind so fetches overlap the next parse
    deferred_flush: List = []

    def drain_deferred(keep: int = 0):
        t_d = time.time()
        while len(deferred_flush) > keep:
            entries, pend = deferred_flush.pop(0)
            _expand_and_enqueue(entries, pend)
        phase["drain_wall"] += time.time() - t_d

    reader = ReadIterator(read1, read2, index1, index2)
    needs_align_merge = layout.merge == MergeStrategy.ALIGN

    anchored_state: List = [None]

    def _anchored_aligner():
        if anchored_state[0] is None:
            from clique_tpu.align.anchored import AnchoredBatchAligner

            anchored_state[0] = AnchoredBatchAligner(
                BatchAligner(scoring, batch_size, fill=fill,
                             use_mesh=use_mesh), scoring)
        return anchored_state[0]

    def flush(pending: List[_Pending]):
        if not pending:
            return
        t_f = time.time()
        _flush_inner(pending)
        phase["flush_wall"] += time.time() - t_f

    def _flush_inner(pending: List[_Pending]):
        from clique_tpu.align.wavefront import WfaAligner

        long_pending = []
        if not isinstance(aligner, WfaAligner):
            long_pending = [p for p in pending
                            if len(p.seq) >= anchored_min_length]
            if long_pending:
                pending = [p for p in pending
                           if len(p.seq) < anchored_min_length]
        refs = [rm.references[p.ref_id].sequence for p in pending]
        reads = [p.seq for p in pending]
        if isinstance(aligner, BatchAligner) and pending:
            # fast path: build records from the raw group matrices with
            # batch-level numpy (no per-read expansion); with the writer
            # thread running, construction is deferred to it so it
            # overlaps the next chunk's parse + dispatch.
            if drain_queue is not None:
                # dispatch here (align_pairs_entries is eager about
                # dispatch + copy_to_host_async, lazy about pulls), then
                # hand the pulls to the drain thread: fetch waits AND
                # numpy expansion leave the main thread entirely. A full
                # queue is backpressure (4 undrained flushes in flight);
                # the wait is charged to drain_wall
                entries = aligner.align_pairs_entries(refs, reads)
                stats.aligned += len(pending)
                t_d = time.time()
                drain_queue.put(("entries", entries, list(pending)))
                phase["drain_wall"] += time.time() - t_d
            elif writer_thread is not None:
                # defer draining THIS flush's results until the next
                # flush has parsed + dispatched: the async device->host
                # copies complete while the main thread parses, so the
                # eventual device_get barely waits (the fetch latency
                # hides behind FASTQ parse)
                deferred_flush.append(
                    (aligner.align_pairs_entries(refs, reads),
                     list(pending)))
                stats.aligned += len(pending)
                if len(deferred_flush) > 1:
                    drain_deferred(1)
            else:
                raws = aligner.align_pairs_raw(refs, reads)
                batch_records = [None] * len(pending)
                caps = [] if sink is not None else None
                for raw in raws:
                    _fill_records_from_raw(raw, pending, batch_records,
                                           layout, rm, report_zero_score,
                                           out_caps=caps)
                if sink is not None:
                    sink.consume_flush(raws, pending, batch_records,
                                       caps=caps)
                emit_records(batch_records)
                stats.aligned += len(pending)
        elif pending:
            out = list(zip(pending, aligner.align_pairs(refs, reads)))
            aligned_out = [AlignedRead(
                read_name=p.name,
                reference_name=rm.references[p.ref_id].name,
                reference_aligned=a1,
                read_aligned=a2,
                quals=p.quals,
                cigar=cigar,
                score=0.0 if report_zero_score else score,
            ) for p, (a1, a2, cigar, score) in out]
            emit_aligned(aligned_out)
            stats.aligned += len(pending)
        if long_pending:
            anchored = _anchored_aligner()
            out = list(zip(long_pending, anchored.align_pairs(
                [rm.references[p.ref_id].sequence for p in long_pending],
                [p.seq for p in long_pending],
                indexes=[rm.references[p.ref_id].index
                         for p in long_pending])))
            aligned_out = [AlignedRead(
                read_name=p.name,
                reference_name=rm.references[p.ref_id].name,
                reference_aligned=a1,
                read_aligned=a2,
                quals=p.quals,
                cigar=cigar,
                score=0.0 if report_zero_score else score,
            ) for p, (a1, a2, cigar, score) in out]
            # emit_aligned drains the deferred fast flush first, so BAM
            # order stays fast-part-then-anchored as before
            emit_aligned(aligned_out)
            stats.aligned += len(long_pending)
        if stats.aligned % 1_000_000 < len(pending) + len(long_pending):
            log.info("Time elapsed in aligning reads (%d) is: %.1fs",
                     stats.aligned, time.time() - start)

    pending: List[_Pending] = []
    merge_pending: List[Tuple[str, bytes, bytes, bytes, bytes]] = []

    route_pending: List[Tuple[str, bytes, bytes]] = []
    exh_pending: List[Tuple[str, bytes, bytes, List[int]]] = []

    def flush_exhaustive():
        """Batched exhaustive search: every (candidate ref, read) pair of every
        queued read goes through ONE align_pairs call; per read the best score
        wins, Rust max_by keeping the LAST maximum on ties
        (exhaustive_alignment_search).

        On the WFA engine, candidates are first SCREENED with the score-only
        wavefront kernel (O(ns) per pair, no traceback/backtrace cost) and
        only each read's winner gets the full traceback alignment (with its
        own adaptive score ceiling + exact-DP fallback, so highly-divergent
        reads still align; if every candidate censors at the screen ceiling
        the tie order picks the last candidate)."""
        if not exh_pending:
            return
        refs: List[bytes] = []
        reads: List[bytes] = []
        spans: List[Tuple[int, int]] = []  # (start, count) into outs per read
        for _name, seq, _quals, cands in exh_pending:
            spans.append((len(refs), len(cands)))
            refs.extend(rm.references[i].sequence for i in cands)
            reads.extend([seq] * len(cands))

        from clique_tpu.align.wavefront import WfaAligner

        if isinstance(aligner, WfaAligner):
            from clique_tpu.align.wavefront import wfa_screen_candidates

            pens = wfa_screen_candidates(
                refs, reads, x=aligner.x, o=aligner.o, e=aligner.e,
                model=aligner.model, o2=aligner.o2, e2=aligner.e2)
            winner_refs: List[bytes] = []
            winner_reads: List[bytes] = []
            winner_best: List[int] = []
            for (name, seq, quals, cands), (start, count) in zip(
                    exh_pending, spans):
                best = 0
                for i in range(count):
                    if pens[start + i] <= pens[start + best]:
                        best = i  # last-minimum = last-maximum of -penalty
                winner_best.append(best)
                winner_refs.append(refs[start + best])
                winner_reads.append(seq)
            outs_w = aligner.align_pairs(winner_refs, winner_reads)
            aligned_out = []
            for (name, seq, quals, cands), best, out in zip(
                    exh_pending, winner_best, outs_w):
                a1, a2, cigar, score = out
                aligned_out.append(AlignedRead(
                    read_name=name,
                    reference_name=rm.references[cands[best]].name,
                    reference_aligned=a1, read_aligned=a2,
                    quals=quals, cigar=cigar, score=score))
            emit_aligned(aligned_out)
            stats.aligned += len(exh_pending)
            exh_pending.clear()
            return

        outs = aligner.align_pairs(refs, reads)
        aligned_out = []
        for (name, seq, quals, cands), (start, count) in zip(
                exh_pending, spans):
            best = 0
            for i in range(count):
                if outs[start + i][3] >= outs[start + best][3]:
                    best = i
            a1, a2, cigar, score = outs[start + best]
            aligned_out.append(AlignedRead(
                read_name=name,
                reference_name=rm.references[cands[best]].name,
                reference_aligned=a1, read_aligned=a2,
                quals=quals, cigar=cigar,
                score=score))
        emit_aligned(aligned_out)
        stats.aligned += len(exh_pending)
        exh_pending.clear()

    def flush_routes():
        if not route_pending:
            return
        routed = hmm_router.route([seq for _n, seq, _q in route_pending])
        for (name, seq, quals), (ref_id, _ll) in zip(route_pending, routed):
            if ref_id < 0:
                stats.failed += 1
                continue
            pending.append(_Pending(name, seq, quals, ref_id))
        route_pending.clear()
        if len(pending) >= batch_size * flush_factor:
            flush(pending)
            pending.clear()

    def process_merged(name: str, seq: bytes, quals: bytes):
        if len(seq) >= max_read_size:
            log.warning(
                "Dropped read %s as its length %d exceeds %dx the reference "
                "length %d", name, len(seq), max_reference_multiplier,
                rm.longest_ref)
            stats.dropped_length += 1
            return
        if len(seq) < min_read_length:
            # the reference parses --min-read-length (main.rs:183-185) but
            # binds it `_min_read_length` and never gates on it
            # (alignment_functions.rs:532) - we enforce the documented
            # intent and drop short reads
            log.warning(
                "Dropped read %s as its length %d is below the minimum "
                "read length %d", name, len(seq), min_read_length)
            stats.dropped_short += 1
            return
        if hmm_router is not None:
            route_pending.append((name, seq, quals))
            if len(route_pending) >= batch_size * 4:
                flush_routes()
            return
        ref_id = _choose_reference(rm, layout, seq, quick_match_threshold)
        if ref_id is None:
            stats.failed += 1
            return
        if isinstance(ref_id, list):
            # exhaustive search: batched below - align against every candidate,
            # best score wins (see flush_exhaustive)
            exh_pending.append((name, seq, quals, ref_id))
            if sum(len(e[3]) for e in exh_pending) >= \
                    batch_size * flush_factor:
                flush_exhaustive()
            return
        # orientation for single reference without known strand
        if single_ref and not layout.known_strand:
            ref = rm.references[ref_id]
            fwd, _f, _r = orient_by_longest_segment(
                seq, ref.sequence, ref.index)
            if not fwd:
                seq = reverse_complement(seq)
                quals = quals[::-1]
        pending.append(_Pending(name, seq, quals, ref_id))
        # accumulate several device batches so align_pairs can keep multiple
        # dispatches in flight (overlapping transfer with compute)
        if len(pending) >= batch_size * flush_factor:
            flush(pending)
            pending.clear()

    def flush_merges():
        if not merge_pending:
            return
        r1s = [m[1] for m in merge_pending]
        r2s = [m[3] for m in merge_pending]
        out = merge_aligner.align_pairs(r1s, r2s)
        for (name, _r1, q1, _r2, q2), (a1, a2, _cigar, _score) in zip(
                merge_pending, out):
            seq, quals = alignment_rate_and_consensus(a1, q1, a2, q2)
            process_merged(name, seq, quals)
        merge_pending.clear()

    # Fast path: with only a read1 stream, unify_read reduces to an
    # orientation passthrough unless the layout concatenates Read1 with
    # Spacers (merger.rs:278-294); for Forward orientation the container +
    # decision-tree hop per read is pure overhead, so feed the records
    # straight into process_merged. Semantics identical to the general
    # loop (quals are NOT reversed in the R1-only branch either way).
    declared_kinds = {p.kind for p in layout.reads if p.kind != "Spacer"}
    concat_single = (layout.merge in (MergeStrategy.CONCATENATE,
                                      MergeStrategy.CONCATENATE_BOTH_FORWARD)
                     and declared_kinds <= {"Read1"})
    r1_orientation = next(
        (p.orientation for p in layout.reads if p.kind == "Read1"),
        AlignedReadOrientation.FORWARD)
    def _shard_filter(it):
        """Yield only this rank's read chunks (see read_shard docstring)."""
        if read_shard is None:
            return it
        rank, world = read_shard

        def gen():
            for i, item in enumerate(it):
                if (i // _SHARD_CHUNK) % world == rank:
                    yield item
        return gen()

    t_reader = time.time()
    if (reader.single_stream and "Read1" in declared_kinds
            and not concat_single
            and r1_orientation == AlignedReadOrientation.FORWARD):
        for rec in _shard_filter(reader.read_one_records()):
            stats.total += 1
            process_merged(rec.name, rec.seq, rec.qual)
    else:
        for rsc in _shard_filter(reader):
            stats.total += 1
            merged = unify_read(rsc, layout,
                                defer_align_merge=needs_align_merge)
            if merged.pending_pair is not None:
                r1, q1, r2, q2 = merged.pending_pair
                merge_pending.append((merged.name, r1, q1, r2, q2))
                if len(merge_pending) >= batch_size * flush_factor:
                    flush_merges()
            else:
                process_merged(merged.name, merged.seq, merged.quals)
    phase["reader_wall"] = time.time() - t_reader

    t_tail = time.time()
    flush_merges()
    if hmm_router is not None:
        flush_routes()
    flush_exhaustive()
    flush(pending)
    drain_deferred()
    phase["tail_wall"] = time.time() - t_tail
    t_join = time.time()
    if writer_thread is not None:
        if drain_thread is not None:
            drain_queue.put(None)   # drain forwards None to write_queue
            drain_thread.join()
        else:
            write_queue.put(None)
        build_thread.join()
        writer_thread.join()
        if sink_thread is not None:
            # after the build thread exits, every sink item is enqueued
            sink_queue.put(None)
            sink_thread.join()
        if writer_error:
            raise writer_error[0]
    writer.close()
    phase["join_wall"] = time.time() - t_join
    if hasattr(writer, "chunk_offsets"):
        # chunk-index sidecar: lets distributed collapse deal byte ranges
        # of this BAM (each process inflates only its share)
        from clique_tpu.io.sam import write_cqi

        write_cqi(output_path, writer.chunk_offsets)
    if profiler_cm is not None:
        profiler_cm.__exit__(None, None, None)
    elapsed = time.time() - start
    log.info("Aligned %d/%d reads in %.1fs", stats.aligned, stats.total,
             elapsed)
    if metrics_path:
        import json

        with open(metrics_path, "w") as fh:
            json.dump({
                "engine": engine,
                "wfa_dp_fallbacks": getattr(aligner, "fallbacks", None),
                "total_reads": stats.total,
                "aligned": stats.aligned,
                "dropped_length": stats.dropped_length,
                "dropped_short": stats.dropped_short,
                "failed": stats.failed,
                "elapsed_s": round(elapsed, 3),
                "reads_per_s": round(stats.aligned / elapsed, 1)
                if elapsed else None,
                "device_seconds": round(aligner.device_seconds, 3),
                "host_post_seconds": round(aligner.post_seconds, 3),
                # main-thread walls: reader_wall = parse loop incl. nested
                # flushes; flush_wall = inside flush() (incl. nested
                # drains); drain_wall = fetch+expand drains; tail/join =
                # post-loop flush + writer-thread join
                "phase_walls": {k: round(v, 3) for k, v in phase.items()},
                "wfa_phase_seconds": {
                    k: round(v, 3) for k, v in
                    aligner.phase_seconds.items()}
                if hasattr(aligner, "phase_seconds") else None,
                "pairs_aligned": aligner.pairs_aligned,
                "dp_cells_filled": aligner.cells_filled,
                "dp_cells_per_s": round(
                    aligner.cells_filled / aligner.device_seconds)
                if aligner.device_seconds else None,
            }, fh, indent=2)
    return stats


def _choose_reference(rm: ReferenceManager, layout: SequenceLayout,
                      seq: bytes, threshold: float):
    """Reference routing (align_to_reference_choices / quick_alignment_search).

    Returns an int ref id, a list of candidate ids (exhaustive search), or
    None when no reference exists."""
    n = len(rm.references)
    if n == 0:
        return None
    if n == 1:
        return next(iter(rm.references))
    votes = rm.vote_references(seq)
    total = sum(votes.values())
    if total == 0:
        return list(rm.references.keys())
    ref, count = votes.most_common(1)[0]
    if count / total > threshold:
        return ref
    return list(votes.keys())


def _fill_records_from_raw(raw, pending: List[_Pending], records: List,
                           layout: SequenceLayout, rm: ReferenceManager,
                           report_zero_score: bool,
                           out_caps: Optional[List] = None) -> None:
    """Build SamRecords for one align_pairs_raw group with batch-level
    numpy (rates, gap-strips, digit-tag captures and cigars computed over
    the whole [G, T] matrices at once). Semantics identical to
    _make_record + AlignedRead.to_sam_record; per-read python overhead was
    ~40% of align wall time at 20k reads."""
    group, a_ref, a_read, valid, ops, n_ops, scores = raw

    # alignment rate over letter columns (consensus_builders.rs:288-307)
    from clique_tpu.extract.extractor import alignment_rates_rows

    rates = alignment_rates_rows(a_ref, a_read).tolist()

    # gap-stripped read sequences (to_sam_record strips gaps, qual 'H')
    keep = valid & (a_read != GAP)
    seq_bounds = np.concatenate(
        ([0], np.cumsum(keep.sum(axis=1)))).tolist()
    seq_flat = a_read[keep]

    cigars = dbatch.cigars_from_ops_batch(ops, n_ops)

    # digit-wildcard captures, one flat mask pass per symbol present in any
    # row's reference (a digit byte only occurs in the owning reference's
    # aligned row, so the union mask is exact per row)
    union_syms: set = set()
    for rid in {pending[k].ref_id for k in group}:
        ref_cfg = layout.references.get(rm.references[rid].name)
        if ref_cfg is not None:
            union_syms.update(u.symbol
                              for u in ref_cfg.umi_configurations.values()
                              if u.symbol.isdigit())
    union_digit = sorted(union_syms)
    digit_hits = {}
    caps_np = {}
    for sym in union_digit:
        mask = (a_ref == ord(sym)) & valid
        cnt = mask.sum(axis=1)
        flat = a_read[mask]
        bounds = np.concatenate(([0], np.cumsum(cnt)))
        digit_hits[sym] = (cnt.tolist(), flat, bounds.tolist())
        caps_np[sym] = (cnt, flat, bounds)
    if out_caps is not None:
        # hand the capture arrays to the CollapseSink so the fused chain
        # doesn't redo the mask passes (chain.py consume_flush)
        out_caps.append(caps_np)

    scores_l = scores.tolist()
    for j, k in enumerate(group):
        p = pending[k]
        ref = rm.references[p.ref_id]
        ref_cfg = layout.references.get(ref.name)
        tags: Dict[str, str] = {}
        if ref_cfg is not None:
            for u in ref_cfg.umi_configurations.values():
                sym = u.symbol
                if sym.isdigit():
                    cnt, flat, bounds = digit_hits[sym]
                    if cnt[j]:
                        tags[f"e{sym}"] = \
                            flat[bounds[j]:bounds[j + 1]].tobytes().decode()
                else:
                    n = int(n_ops[j])
                    extracted = extract_tagged_sequences(
                        a_read[j, :n].tobytes(), a_ref[j, :n].tobytes())
                    hit = extracted.get(ord(sym))
                    if hit is not None:
                        tags[f"e{sym}"] = hit
        tags["rc"] = "1"
        tags["ar"] = p.name
        tags["rm"] = _fmt(rates[j])
        score = 0.0 if report_zero_score else float(scores_l[j])
        tags["rs"] = _fmt(score)
        tags["as"] = _fmt(score)
        seq = seq_flat[seq_bounds[j]:seq_bounds[j + 1]].tobytes()
        records[k] = SamRecord(
            name=p.name, flag=0, reference_name=ref.name, pos=1, mapq=255,
            cigar=cigars[j], seq=seq, qual=b"H" * len(seq), tags=tags)


def _flush_fastpath_syms(pend, layout: SequenceLayout,
                         rm: ReferenceManager):
    """Fast-path eligibility for a flush: every reference present must
    share ONE ordered, all-digit UMI symbol tuple (or have no config).
    Returns that tuple, or None when ineligible (mixed orders or
    extractor-zone symbols need the per-record python path)."""
    syms_tuple = None
    for rid in {p.ref_id for p in pend}:
        cfg = layout.references.get(rm.references[rid].name)
        if cfg is None:
            continue
        t = tuple(u.symbol for u in cfg.umi_configurations.values())
        if any(not s.isdigit() for s in t):
            return None
        if syms_tuple is None:
            syms_tuple = t
        elif t != syms_tuple:
            return None
    return syms_tuple or ()


def _encode_flush_fastpath(raws, pend, layout: SequenceLayout,
                           rm: ReferenceManager, report_zero_score: bool,
                           bam_ref_idx: Dict[int, int], syms):
    """Assemble a whole flush's BAM record-stream bytes through the native
    fast-path encoder (encode_fastpath_records in native/bamcodec.c): no
    SamRecord objects, no tags dicts, no per-record encode loop — the
    byte output is identical to _fill_records_from_raw +
    encode_records_bytes (pinned by the golden tests).

    Returns (encoded_bytes, caps_by_group, cigars_by_k, seq_len_by_k) or
    None when the native lib is unavailable (callers fall back to the
    python record path)."""
    import ctypes

    from clique_tpu.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    syms_b = "".join(syms).encode()
    n_total = len(pend)
    bufs = []                    # per group: (group, buffer, rec_off)
    caps_by_group = []
    cigars_by_k: List = [None] * n_total
    seq_len_by_k = [0] * n_total
    for raw in raws:
        group, a_ref, a_read, valid, ops, n_ops, scores = raw
        g = len(group)

        from clique_tpu.extract.extractor import alignment_rates_rows

        rates = alignment_rates_rows(a_ref, a_read).tolist()

        keep = valid & (a_read != GAP)
        seq_lens = keep.sum(axis=1)
        seq_off = np.zeros(g + 1, dtype=np.int64)
        np.cumsum(seq_lens, out=seq_off[1:])
        seq_flat = np.ascontiguousarray(a_read[keep])

        counts, opcodes, cbounds = dbatch.cigar_runs_from_ops_batch(
            ops, n_ops)
        cig_tuples = dbatch.cigars_from_runs(counts, opcodes, cbounds)

        cap_parts = []
        cap_base = np.zeros(max(len(syms), 1), dtype=np.int64)
        cap_bounds = np.zeros((max(len(syms), 1), g + 1), dtype=np.int64)
        caps_np = {}
        base = 0
        for si, sym in enumerate(syms):
            mask = (a_ref == ord(sym)) & valid
            cnt = mask.sum(axis=1)
            flat = np.ascontiguousarray(a_read[mask])
            bounds = np.zeros(g + 1, dtype=np.int64)
            np.cumsum(cnt, out=bounds[1:])
            cap_parts.append(flat)
            cap_base[si] = base
            cap_bounds[si] = bounds
            base += len(flat)
            caps_np[sym] = (cnt, flat, bounds)
        cap_blob = (b"".join(p.tobytes() for p in cap_parts)
                    if cap_parts else b"")
        caps_by_group.append(caps_np)

        names = [pend[k].name for k in group]
        name_blob = "".join(names).encode()
        name_off = np.zeros(g + 1, dtype=np.int64)
        np.cumsum([len(nm) for nm in names], out=name_off[1:])

        rm_strs = [_fmt(r) for r in rates]
        rm_blob = "".join(rm_strs).encode()
        rm_off = np.zeros(g + 1, dtype=np.int64)
        np.cumsum([len(s) for s in rm_strs], out=rm_off[1:])
        if report_zero_score:
            sc_strs = ["0"] * g
        else:
            sc_strs = [_fmt(float(s)) for s in scores.tolist()]
        sc_blob = "".join(sc_strs).encode()
        sc_off = np.zeros(g + 1, dtype=np.int64)
        np.cumsum([len(s) for s in sc_strs], out=sc_off[1:])

        ref_ids = np.array([bam_ref_idx[pend[k].ref_id] for k in group],
                           dtype=np.int32)

        cap = int(48 * g + 2 * len(name_blob) + 4 * len(counts)
                  + 2 * int(seq_off[-1]) + len(cap_blob) + len(rm_blob)
                  + 2 * len(sc_blob) + (4 * len(syms) + 30) * g + 64)
        out = ctypes.create_string_buffer(cap)
        rec_off = np.zeros(g + 1, dtype=np.int64)
        written = lib.encode_fastpath_records(
            g, ref_ids.ctypes.data,
            name_blob, name_off.ctypes.data,
            counts.ctypes.data, opcodes.ctypes.data, cbounds.ctypes.data,
            seq_flat.ctypes.data_as(ctypes.c_char_p), seq_off.ctypes.data,
            len(syms), syms_b,
            cap_blob, cap_base.ctypes.data, cap_bounds.ctypes.data,
            rm_blob, rm_off.ctypes.data,
            sc_blob, sc_off.ctypes.data,
            out, cap, rec_off.ctypes.data)
        if written < 0:
            raise RuntimeError("fastpath encode capacity underestimated")
        bufs.append((group, out.raw[:written], rec_off))
        for j, k in enumerate(group):
            cigars_by_k[k] = cig_tuples[j]
            seq_len_by_k[k] = int(seq_lens[j])

    # assemble in pend (BAM write) order; groups are usually contiguous
    # ascending (uniform-shape flushes), where a straight join suffices
    order = np.concatenate([np.asarray(g_, dtype=np.int64)
                            for g_, _b, _o in bufs])
    if np.array_equal(order, np.arange(n_total, dtype=np.int64)):
        data = b"".join(b for _g, b, _o in bufs)
    else:
        where = {}
        for gi, (group, _b, _o) in enumerate(bufs):
            for j, k in enumerate(group):
                where[k] = (gi, j)
        views = [memoryview(b) for _g, b, _o in bufs]
        parts = []
        for k in range(n_total):
            gi, j = where[k]
            off = bufs[gi][2]
            parts.append(views[gi][int(off[j]):int(off[j + 1])])
        data = b"".join(parts)
    return data, caps_by_group, cigars_by_k, seq_len_by_k


def _make_record(aligned: AlignedRead, layout: SequenceLayout) -> SamRecord:
    ref_cfg = layout.references.get(aligned.reference_name)
    tags: Dict[str, str] = {}
    if ref_cfg is not None:
        symbols = [u.symbol for u in ref_cfg.umi_configurations.values()]
        digit_syms = [s for s in symbols if s.isdigit()]
        extracted_fast = extract_digit_tags_fast(
            aligned.read_aligned, aligned.reference_aligned, digit_syms)
        for sym in digit_syms:
            hit = extracted_fast.get(sym)
            if hit is not None:
                tags[f"e{sym}"] = hit
        non_digit = [s for s in symbols if not s.isdigit()]
        if non_digit:
            extracted = extract_tagged_sequences(
                aligned.read_aligned, aligned.reference_aligned)
            for sym in non_digit:
                hit = extracted.get(ord(sym))
                if hit is not None:
                    tags[f"e{sym}"] = hit
    tags["rc"] = "1"
    tags["ar"] = aligned.read_name
    return aligned.to_sam_record(tags)


def _write_aligned(writer, aligned: AlignedRead, layout: SequenceLayout,
                   stats: AlignStats) -> None:
    writer.write(_make_record(aligned, layout))
