"""Multi-host collapse: the distributed version of the collapse pipeline.

The reference engine is single-node: its shardio external-memory sort
(/root/reference/rust_cmd/src/collapse.rs:468-469) is the boundary that
becomes cross-host communication at multi-host scale (SURVEY 2.11 P4/P5, BASELINE
north star: "UMI groups spanning hosts are merged via all-gather/psum
collectives before consensus"). This module wires that design end-to-end:

- every process ingests a deterministic slice of the input BAM: with a
  chunk-index sidecar (<bam>.cqi, minted by align) it seeks straight to
  its byte ranges and inflates only O(filesize/P) of the BGZF stream;
  without one, record chunks are dealt round-robin from a full walk;
- with out_of_core (auto when maximum_subsequences caps are set or the
  BAM exceeds 4GB), each process spills its slice to LOCAL per-reference
  shards and runs every level as two streaming passes — per-bin resident
  reads stay O(1) at any scale;
- per correction level, tag counting is LOCAL; per-bin count dictionaries
  are exchanged through the shared filesystem (the all-to-all payload
  path, mirroring shardio's disk boundary), while bin-bucket histograms
  are psum-merged over the global device mesh (parallel/groupby.py) to
  assign each bin a deterministic owner balanced by load;
- each owner builds its bins' correction maps with the device kernels,
  publishes them, and every process applies the merged maps to its local
  reads — reads never move during correction (correction maps depend only
  on tag counts, so shipping counts beats shipping reads);
- before consensus, the one real read exchange: reads are spilled into
  hash-partitioned shards keyed by their final group key
  (collapse/shards.py — equal keys always share a shard id), shard ids
  are dealt to owners, and each owner consensus-collapses its shards;
- each owner writes its consensus records into a part BAM; process 0
  merges the parts by raw BGZF-block append (concat_bam_parts — no
  pickling or re-encoding on the critical rank).

Synchronization uses jax.distributed + multihost_utils.sync_global_devices
(every barrier is a named collective over all hosts). Run one process per
host with identical arguments plus a distinct process_id; single-process
calls (num_processes=1) skip jax.distributed and reduce to the in-RAM
pipeline semantics. Output record MULTISET is identical to single-host
collapse(); record order follows shard order (grouping, not order, is the
contract — see shards.iter_sorted_groups).
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

log = logging.getLogger(__name__)


def init_distributed(coordinator_address: Optional[str],
                     num_processes: int, process_id: int) -> None:
    """jax.distributed.initialize (idempotent): the collectives backbone
    for multi-process runs. The coordinator address and process count are
    always passed explicitly. With one process per card, the launcher
    gives each rank its card through CUDA_VISIBLE_DEVICES, so no rank
    reserves memory on another's card."""
    import jax

    if num_processes <= 1:
        return
    if jax.distributed.is_initialized():
        return  # already initialized (e.g. by the launcher)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def _barrier(name: str, num_processes: int) -> None:
    if num_processes <= 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def global_mesh():
    """1-D 'data' mesh over every device of every process."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), axis_names=("data",))


def psum_histogram(mesh, local_hist) -> "np.ndarray":
    """Cross-process merge of per-bucket counts: each process contributes
    its local histogram row into a globally-sharded [n_devices, n_buckets]
    array; one jitted sum reduces over the sharded axis (XLA inserts the
    psum across hosts). Replicated result on every process."""
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_buckets = int(local_hist.shape[0])
    n_local = jax.local_device_count()
    local_rows = np.zeros((n_local, n_buckets), dtype=np.int32)
    local_rows[0] = local_hist
    sharding = NamedSharding(mesh, P("data"))
    if jax.process_count() > 1:
        garr = jax.make_array_from_process_local_data(sharding, local_rows)
    else:
        garr = jax.device_put(local_rows, sharding)

    @functools.partial(jax.jit, out_shardings=NamedSharding(mesh, P()))
    def reduce(rows):
        return jnp.sum(rows, axis=0)

    return np.asarray(reduce(garr))


# --- distributed align --------------------------------------------------------

def align_distributed(layout, rm, output_path: str, work_dir: str, *,
                      read1: str, read2: Optional[str] = None,
                      index1: Optional[str] = None,
                      index2: Optional[str] = None,
                      process_id: int = 0, num_processes: int = 1,
                      coordinator_address: Optional[str] = None,
                      **align_kwargs):
    """Multi-host align: the north-star first clause — "read batches stream
    data-parallel from FASTQ shards, one shard set per host" (SURVEY 2.11
    P1; the rayon fanout of alignment_functions.rs:90-93 scaled across
    processes).

    Every process calls this with identical arguments except process_id:
    each runs the full align_reads pipeline on its deterministic stripe of
    read chunks (align_reads read_shard) against replicated references,
    writing a part BAM in the shared work_dir; rank 0 merges the parts by
    raw BGZF-block append (io/sam.py:concat_bam_parts — header written
    once, record blocks concatenated, no recompression). Output record
    MULTISET equals single-process align_reads; record order follows
    (rank, stripe) order. output_path must be .bam. Returns AlignStats for
    the LOCAL slice.

    Part BAMs are explicit RESUME points (SURVEY section 5's "natural
    resume points ... should become persistable artifacts"): a restarted
    rank whose part is already complete — EOF block present and the .cqi
    sidecar's sentinel matches the file — skips its alignment and goes
    straight to the barrier, so one failed host re-runs only its own
    stripe. An interrupted part fails this validation (the sentinel is
    written at close) and is redone."""
    from clique_tpu.align.pipeline import align_reads
    from clique_tpu.io.sam import concat_bam_parts, read_cqi

    if not str(output_path).endswith(".bam"):
        raise ValueError("distributed align writes BAM output only")
    init_distributed(coordinator_address, num_processes, process_id)
    os.makedirs(work_dir, exist_ok=True)
    t0 = time.time()
    if num_processes > 1 and align_kwargs.get("metrics_path"):
        # per-rank metrics: every process reports its LOCAL slice — a
        # shared path would race and misreport one rank's stats as the
        # run's
        align_kwargs["metrics_path"] = \
            f"{align_kwargs['metrics_path']}.rank{process_id}"
    part = os.path.join(work_dir, f"part.p{process_id}.bam")

    # resume requires BOTH internal completeness (EOF + cqi sentinel) and
    # a matching run signature — a stale part from a different world size
    # or input set must be redone, not silently merged
    def _sig(p):
        try:
            st = os.stat(p)
            return [str(p), st.st_size, int(st.st_mtime)]
        except OSError:
            return [str(p), -1, -1]
    run_sig = {"world": num_processes,
               "inputs": [_sig(p) for p in (read1, read2, index1, index2)
                          if p and p != "NONE"]}
    sig_path = part + ".run"
    resume_ok = False
    if os.path.exists(part) and read_cqi(part) is not None:
        try:
            import json

            with open(sig_path) as fh:
                resume_ok = json.load(fh) == run_sig
        except (OSError, ValueError):
            resume_ok = False
    if resume_ok:
        log.info("p%d: part BAM already complete for this run signature, "
                 "resuming past align", process_id)
        stats = None
    else:
        stats = align_reads(
            layout, rm, part, read1=read1, read2=read2, index1=index1,
            index2=index2,
            read_shard=(process_id, num_processes) if num_processes > 1
            else None,
            **align_kwargs)
        import json

        with open(sig_path + ".tmp", "w") as fh:
            json.dump(run_sig, fh)
        os.replace(sig_path + ".tmp", sig_path)
    _barrier("align-parts", num_processes)
    if process_id == 0:
        references = [(r.name, len(r.sequence))
                      for r in rm.references.values()]
        nbytes = concat_bam_parts(
            output_path, references,
            [os.path.join(work_dir, f"part.p{p}.bam")
             for p in range(num_processes)])
        log.info("distributed align: %d processes, %d part bytes merged, "
                 "%.1fs", num_processes, nbytes, time.time() - t0)
    _barrier("align-done", num_processes)
    return stats


# --- distributed collapse -----------------------------------------------------

def _iter_slice_chunks(input_bam: str, process_id: int,
                       num_processes: int):
    """(references, iterator of this process's decompressed record-stream
    chunks): a deterministic disjoint cover of the input BAM.

    With a chunk-index sidecar (<bam>.cqi, minted by align_reads /
    concat_bam_parts) each process seeks straight to its byte ranges and
    inflates ONLY those BGZF blocks — O(filesize/P) inflation per process
    (collapse.rs:437-491's indexed access scaled across hosts). Without
    one, every process walks the whole stream and keeps chunks i with
    i % P == rank (O(P x filesize) total inflation — the fallback)."""
    from clique_tpu.io.sam import bam_ingest_ranges, read_voffset_range
    from clique_tpu.collapse.workers import (_count_chunk_records,
                                             iter_record_chunks)

    references, ranges = bam_ingest_ranges(input_bam)
    if ranges:
        def chunks():
            for i in range(process_id, len(ranges), num_processes):
                vbeg, vend, base_ord = ranges[i]
                yield read_voffset_range(input_bam, vbeg, vend), base_ord
        return references, chunks()

    references, all_chunks = iter_record_chunks(input_bam)

    def dealt():
        base_ord = 0
        for i, chunk in enumerate(all_chunks):
            if i % num_processes == process_id:
                yield chunk, base_ord
            # count records in every chunk (cheap block_size walk over
            # the already-inflated bytes) so ordinals stay global
            base_ord += _count_chunk_records(chunk)
    return references, dealt()


def _ingest_slice(input_bam: str, layout, rm, process_id: int,
                  num_processes: int, stats,
                  spill_writers: Optional[Dict[str, object]] = None
                  ) -> Dict[str, List]:
    """Ingest this process's slice of the input BAM (_iter_slice_chunks).
    With spill_writers (name -> ShardWriter), reads spill out-of-core
    instead of accumulating in RAM (the distributed maximum_subsequences
    path); the returned lists are then empty."""
    from clique_tpu.collapse.pipeline import _RefIngest
    from clique_tpu.io.sam import decode_record_stream

    references, chunks = _iter_slice_chunks(input_bam, process_id,
                                            num_processes)
    ingests = {name: _RefIngest(name, rm, layout,
                                spill=(spill_writers or {}).get(name))
               for name in layout.references}
    for chunk, base_ord in chunks:
        for j, rec in enumerate(decode_record_stream(chunk, references,
                                                     parse_tags=False)):
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
            # globally monotone input-position stamp (chunk base + index)
            ing._next_ordinal = base_ord + j
            ing.ingest(rec, stats)
    return {name: ing.finish(stats) for name, ing in ingests.items()}


def _local_bin_counts(reads: List, tag) -> Dict[Tuple, Counter]:
    """Per-bin (reference, corrected-prefix) counters of the gap-stripped
    next tag, after the push() length gate (correct_tags.rs:50-120)."""
    from clique_tpu.collapse.pipeline import _gate_tag

    counts: Dict[Tuple, Counter] = {}
    for read in reads:
        gapless = _gate_tag(read, tag)
        if gapless is not None:
            bin_key = (read.reference_name,) + read.key_tuple()
            counts.setdefault(bin_key, Counter())[gapless] += 1
    return counts


def _merge_level_counts(level_dir: str, num_processes: int
                        ) -> Dict[Tuple, Counter]:
    merged: Dict[Tuple, Counter] = {}
    for p in range(num_processes):
        with open(os.path.join(level_dir, f"counts.p{p}.pkl"), "rb") as fh:
            for bin_key, counter in pickle.load(fh).items():
                if bin_key in merged:
                    merged[bin_key].update(counter)
                else:
                    merged[bin_key] = Counter(counter)
    return merged


def _exchange_correction_maps(local_counts: Dict[Tuple, Counter], tag,
                              known_lists, mesh, level_dir: str,
                              process_id: int, num_processes: int,
                              n_buckets: int) -> Dict[Tuple, Dict]:
    """The cross-host core of one correction level: publish local tag
    counters (shared-FS all-to-all payload), psum the bin-bucket histogram
    over the mesh for deterministic load-balanced ownership, owners build
    correction maps over the GLOBAL counts with the device kernels, and
    the merged maps are returned on every process."""
    import numpy as np

    from clique_tpu.collapse.pipeline import _known_correction
    from clique_tpu.config.layout import UMISortType
    from clique_tpu.parallel.groupby import assign_bucket_owners, tag_bucket

    os.makedirs(level_dir, exist_ok=True)
    with open(os.path.join(level_dir, f"counts.p{process_id}.pkl.tmp"),
              "wb") as fh:
        pickle.dump(local_counts, fh, protocol=4)
    os.replace(os.path.join(level_dir, f"counts.p{process_id}.pkl.tmp"),
               os.path.join(level_dir, f"counts.p{process_id}.pkl"))

    local_hist = np.zeros(n_buckets, dtype=np.int32)
    for bin_key, counter in local_counts.items():
        local_hist[tag_bucket(pickle.dumps(bin_key, protocol=4),
                              n_buckets)] += sum(counter.values())
    _barrier(f"counts-level-{tag.order}", num_processes)
    hist = psum_histogram(mesh, local_hist)
    owner = assign_bucket_owners(hist, num_processes)

    merged = _merge_level_counts(level_dir, num_processes)
    mine = [bk for bk in merged
            if int(owner[tag_bucket(pickle.dumps(bk, protocol=4),
                                    n_buckets)]) == process_id]
    from clique_tpu.collapse.correct import correct_degenerate_groups

    if tag.sort_type == UMISortType.DEGENERATE_TAG:
        corrections = correct_degenerate_groups(
            [merged[bk] for bk in mine], tag.max_distance, tag.length,
            tag.minimum_collapsing_difference or 5.0)
    else:
        corrections = [_known_correction(merged[bk], tag, known_lists)
                       for bk in mine]
    with open(os.path.join(level_dir, f"maps.p{process_id}.pkl.tmp"),
              "wb") as fh:
        pickle.dump(dict(zip(mine, corrections)), fh, protocol=4)
    os.replace(os.path.join(level_dir, f"maps.p{process_id}.pkl.tmp"),
               os.path.join(level_dir, f"maps.p{process_id}.pkl"))
    _barrier(f"maps-level-{tag.order}", num_processes)

    maps: Dict[Tuple, Dict] = {}
    for p in range(num_processes):
        with open(os.path.join(level_dir, f"maps.p{p}.pkl"), "rb") as fh:
            maps.update(pickle.load(fh))
    log.info("p%d level %s: %d bins (%d owned)", process_id, tag.symbol,
             len(merged), len(mine))
    return maps


def distributed_sort_level(reads: List, tag, known_lists, mesh,
                           level_dir: str, process_id: int,
                           num_processes: int,
                           n_buckets: int = 256) -> List:
    """One correction level across hosts (in-RAM local reads): count
    locally, exchange maps, apply. Returns this process's corrected
    reads."""
    from clique_tpu.collapse.pipeline import _apply_correction_one, _gate_tag

    local_counts = _local_bin_counts(reads, tag)
    maps = _exchange_correction_maps(local_counts, tag, known_lists, mesh,
                                     level_dir, process_id, num_processes,
                                     n_buckets)
    out: List = []
    for read in reads:
        if _gate_tag(read, tag) is None:
            continue
        bin_key = (read.reference_name,) + read.key_tuple()
        applied = _apply_correction_one(read, tag, maps[bin_key])
        if applied is not None:
            out.append(applied)
    log.info("p%d level %s: %d -> %d reads", process_id, tag.symbol,
             len(reads), len(out))
    return out


def distributed_sort_level_spill(in_dir: str, tag, known_lists, mesh,
                                 level_dir: str, out_dir: str,
                                 process_id: int, num_processes: int,
                                 n_buckets: int = 256,
                                 n_shards: int = 32) -> Tuple[int, int]:
    """Out-of-core distributed level: two streaming passes over this
    process's LOCAL spill shards (per-bin resident reads O(1), honoring
    maximum_subsequences exactly like sort_level_spill), with the same
    cross-host count/map exchange as the in-RAM path. Returns local
    (reads_in, reads_out)."""
    from clique_tpu.collapse.pipeline import _apply_correction_one, _gate_tag
    from clique_tpu.collapse.shards import ShardWriter, iter_items

    local_counts: Dict[Tuple, Counter] = {}
    n_in = 0
    for _key, read in iter_items(in_dir):
        n_in += 1
        gapless = _gate_tag(read, tag)
        if gapless is not None:
            bin_key = (read.reference_name,) + read.key_tuple()
            local_counts.setdefault(bin_key, Counter())[gapless] += 1

    maps = _exchange_correction_maps(local_counts, tag, known_lists, mesh,
                                     level_dir, process_id, num_processes,
                                     n_buckets)
    n_out = 0
    with ShardWriter(out_dir, n_shards=n_shards) as out_writer:
        for _key, read in iter_items(in_dir):
            if _gate_tag(read, tag) is None:
                continue
            bin_key = (read.reference_name,) + read.key_tuple()
            applied = _apply_correction_one(read, tag, maps[bin_key])
            if applied is not None:
                out_writer.push(applied.spill_key(), applied)
                n_out += 1
    log.info("p%d level %s (out-of-core): %d -> %d reads", process_id,
             tag.symbol, n_in, n_out)
    return n_in, n_out


def collapse_distributed(output_path: str, layout, input_bam: str,
                         work_dir: str, *, process_id: int = 0,
                         num_processes: int = 1,
                         coordinator_address: Optional[str] = None,
                         correct_only: bool = False,
                         downsample_cap: int = 40,
                         n_shards: int = 32,
                         n_buckets: int = 256,
                         out_of_core: Optional[bool] = None):
    """Distributed collapse over num_processes hosts sharing work_dir.

    Every process calls this with identical arguments except process_id;
    process 0 writes the output BAM (returns CollapseStats for the LOCAL
    slice on every process).

    out_of_core=None auto-enables the streaming path exactly like
    collapse(): when any maximum_subsequences cap is set (per-bin
    resident reads must stay O(1), collapse.rs:884-888) or the input BAM
    exceeds 4GB. In that mode each process spills its slice to LOCAL
    per-reference shards and every level runs as two streaming passes
    (distributed_sort_level_spill)."""
    import shutil

    from clique_tpu.collapse.pipeline import (
        CollapseStats,
        _consensus_record,
        load_known_lists,
        ref_seq_map,
    )
    from clique_tpu.collapse.shards import (ShardWriter, iter_items,
                                            _read_shard)
    from clique_tpu.reference.manager import ReferenceManager

    if not str(output_path).endswith(".bam"):
        raise ValueError("distributed collapse writes BAM output only")
    init_distributed(coordinator_address, num_processes, process_id)
    mesh = global_mesh()
    rm = ReferenceManager.from_layout(layout)
    known_lists = load_known_lists(layout)
    stats = CollapseStats()
    t0 = time.time()

    if out_of_core is None:
        caps = any(cfg.maximum_subsequences is not None
                   for ref in layout.references.values()
                   for cfg in ref.umi_configurations.values())
        try:
            big = os.path.getsize(input_bam) > 4 << 30
        except OSError:
            big = False
        out_of_core = caps or big
        if out_of_core:
            log.info("distributed collapse: out-of-core enabled "
                     "(caps=%s, big=%s)", caps, big)

    def _safe(name: str) -> str:
        return "".join(c if c.isalnum() else "_" for c in name)

    # the one read exchange target: spill by final group key, owners
    # collapse (filled either from RAM lists or local level shards)
    spill_dir = os.path.join(work_dir, f"final.p{process_id}")

    if out_of_core:
        local_root = os.path.join(work_dir, f"local.p{process_id}")
        spill_writers = {}
        for ref in rm.references.values():
            sw = ShardWriter(os.path.join(local_root, f"{_safe(ref.name)}.l0"),
                             n_shards=n_shards)
            spill_writers[ref.name] = sw
        _ingest_slice(input_bam, layout, rm, process_id, num_processes,
                      stats, spill_writers=spill_writers)
        for sw in spill_writers.values():
            sw.close()
        with ShardWriter(spill_dir, n_shards=n_shards) as final_sw:
            for ref in rm.references.values():
                safe = _safe(ref.name)
                in_dir = os.path.join(local_root, f"{safe}.l0")
                for lvl, tag in enumerate(
                        layout.get_sorted_umi_configurations(ref.name)):
                    level_dir = os.path.join(work_dir, f"{safe}.l{lvl}")
                    out_dir = os.path.join(local_root, f"{safe}.l{lvl + 1}")
                    distributed_sort_level_spill(
                        in_dir, tag, known_lists, mesh, level_dir, out_dir,
                        process_id, num_processes, n_buckets=n_buckets,
                        n_shards=n_shards)
                    shutil.rmtree(in_dir, ignore_errors=True)
                    in_dir = out_dir
                for _key, r in iter_items(in_dir):
                    final_sw.push((r.reference_name,) + r.key_tuple(), r)
                shutil.rmtree(in_dir, ignore_errors=True)
    else:
        reads_by_ref = _ingest_slice(input_bam, layout, rm, process_id,
                                     num_processes, stats)
        for ref in rm.references.values():
            reads = reads_by_ref.get(ref.name, [])
            safe = _safe(ref.name)
            for lvl, tag in enumerate(
                    layout.get_sorted_umi_configurations(ref.name)):
                level_dir = os.path.join(work_dir, f"{safe}.l{lvl}")
                reads = distributed_sort_level(
                    reads, tag, known_lists, mesh, level_dir, process_id,
                    num_processes, n_buckets=n_buckets)
            reads_by_ref[ref.name] = reads

        with ShardWriter(spill_dir, n_shards=n_shards) as sw:
            for reads in reads_by_ref.values():
                for r in reads:
                    sw.push((r.reference_name,) + r.key_tuple(), r)
    _barrier("final-spill", num_processes)

    # owners consensus-collapse their shards and write a part BAM each;
    # rank 0 merges the parts by raw BGZF-block append (no pickling, no
    # re-encode — the same merge as distributed align)
    from clique_tpu.io.sam import BamWriter, concat_bam_parts

    references = [(r.name, len(r.sequence)) for r in rm.references.values()]
    ref_seqs = ref_seq_map(rm)
    part_path = os.path.join(work_dir, f"outpart.p{process_id}.bam")
    total_local = 0
    with BamWriter(part_path, references) as part_writer:
        for s in range(n_shards):
            if s % num_processes != process_id:
                continue
            items: List = []
            for p in range(num_processes):
                path = os.path.join(work_dir, f"final.p{p}",
                                    f"shard{s:04d}.cqs")
                if os.path.exists(path):
                    items.extend(_read_shard(path))
            # ordinal tiebreak: group members in input-BAM order no
            # matter which process ingested them
            items.sort(key=lambda kv: (kv[0], kv[1].ordinal))
            records = []
            i = 0
            while i < len(items):
                j = i
                key = items[i][0]
                while j < len(items) and items[j][0] == key:
                    j += 1
                group = [it for _k, it in items[i:j]]
                i = j
                units = [[r] for r in group] if correct_only else [group]
                for g in units:
                    rec = _consensus_record(
                        g, ref_seqs,
                        downsample_cap if not correct_only else 0, 0.75)
                    if rec is not None:
                        records.append(rec)
            part_writer.write_batch(records)
            total_local += len(records)
    _barrier("records", num_processes)

    if process_id == 0:
        total = concat_bam_parts(
            output_path, references,
            [os.path.join(work_dir, f"outpart.p{p}.bam")
             for p in range(num_processes)])
        log.info("distributed collapse: %d processes, %d local records, "
                 "%d part bytes merged, %.1fs", num_processes, total_local,
                 total, time.time() - t0)
    _barrier("done", num_processes)
    return stats
