#!/usr/bin/env python
"""Benchmark: end-to-end align + collapse + call throughput on one GPU.

Runs the FUSED chain (FASTQ decode -> merge -> batched device DP ->
traceback -> tag extraction -> BAM -> in-memory collapse ingestion ->
hierarchical cell/UMI correction -> consensus BAM -> event calling) on a
synthetic ONT-like single-cell lineage dataset (BASELINE configs 1+3
shape: ~340bp amplicon with ten Cas9 targets, 16bp cell barcode + 12bp
UMI, 500 cells x 4 UMIs, 80k reads) and prints ONE JSON line with chain
reads/s plus an align/collapse/call breakdown and the device it ran on.
It runs in one process and exits non-zero when JAX finds no GPU.

The chain uses clique_tpu.chain (align hands records to collapse in
memory; outputs byte-identical to the two-command path, pinned by
tests/test_chain_fused.py). The `call` stage is BASELINE config 3's third
verb and is part of the timed chain.

vs_baseline: the reference publishes no numbers (BASELINE.md) and its
Rust crate cannot build here (no cargo, zero egress), so the baseline is
MEASURED from a faithful C reimplementation of its hot loops
(clique_tpu/native/refdp.c): the 3-plane fill+traceback per read PLUS a
collapse-stage model (extraction walk, unique-tag clustering, stretcher
column consensus) run on this host with the reference's rayon-style
thread fanout. The JSON carries vs_baseline_basis; without a C compiler
it falls back to a labeled align-anchored cost model.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def write_dataset(tmp: str, n_reads: int = 80000, seed: int = 2026) -> dict:
    """Write the bench deployment into `tmp`: the layout YAML and a FASTQ
    of `n_reads` reads. Returns the paths and the generator's shape
    (reference, read length, cells and UMIs per cell)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)

    # Representative GESTALT-style lineage amplicon (BASELINE configs 1/3):
    # ~340bp with a 16bp cell barcode, 12bp UMI, and ten 23bp Cas9 target
    # sites separated by fixed linkers - the shape real ONT lineage
    # libraries have (the reference's own test amplicons are 0.2-1.9kb).
    a5 = "TTCAGACGTGTGCTCTTCCGATCT"
    a3 = "AGATCGGAAGAGCACACGTCTGAA"
    targets = [rng.choice(bases, 20).tobytes().decode() + "TGG"
               for _ in range(10)]
    linker = "GAAA"
    target_block = linker.join(targets)
    ref_seq = f"{a5}{'0' * 16}{'1' * 12}{target_block}{a3}"

    layout_path = os.path.join(tmp, "layout.yaml")
    target_list = ", ".join(f'"{t}"' for t in targets)
    type_list = ", ".join('"Cas9WT"' for _ in targets)
    with open(layout_path, "w") as fh:
        fh.write(f"""
known_strand: true
reads:
  - !Read1
    orientation: Forward
references:
  amplicon1:
    sequence: "{ref_seq}"
    targets: [{target_list}]
    target_types: [{type_list}]
    umi_configurations:
      cell_id: {{symbol: '0', sort_type: "DegenerateTag", length: 16, order: 0, max_distance: 2}}
      cell_umi: {{symbol: '1', sort_type: "DegenerateTag", length: 12, order: 1, max_distance: 2}}
""")
    fq = os.path.join(tmp, "reads.fastq")
    sub_p = 0.05
    base_read = np.frombuffer(
        (a5 + "N" * 28 + target_block + a3).encode(), dtype=np.uint8)
    L = len(base_read)
    # single-cell structure: 500 cells x 4 UMIs, reads dealt round-robin
    # (160 reads per cell at 80k) - exercises global cell-barcode
    # clustering, per-cell UMI correction, and consensus groups
    n_cells, n_umis = 500, 4
    cells = rng.choice(bases, (n_cells, 16))
    umis = rng.choice(bases, (n_cells, n_umis, 12))
    with open(fq, "w") as fh:
        for i in range(n_reads):
            c = i % n_cells
            read = base_read.copy()
            read[24:40] = cells[c]
            read[40:52] = umis[c, (i // n_cells) % n_umis]
            subs = rng.random(L) < sub_p          # ONT-like substitutions
            read[subs] = rng.choice(bases, int(subs.sum()))
            fh.write(f"@r{i}\n{read.tobytes().decode()}\n+\n{'I' * L}\n")
    return {"layout": layout_path, "fastq": fq, "ref_seq": ref_seq,
            "read_len": L, "n_cells": n_cells, "n_umis": n_umis}


def main() -> None:
    from clique_tpu.utils.jaxcfg import device_report, enable_persistent_cache

    enable_persistent_cache()
    report = device_report()
    log(f"device: {report}")
    if report["platform"] != "gpu":
        raise SystemExit(f"bench needs a GPU; JAX found {report['platform']}")

    from clique_tpu.align.pipeline import align_reads
    from clique_tpu.chain import CollapseSink, collapse_from_reads
    from clique_tpu.config.layout import SequenceLayout
    from clique_tpu.reference.manager import ReferenceManager

    n_reads = int(os.environ.get("CLIQUE_BENCH_READS", "80000"))
    batch = int(os.environ.get("CLIQUE_BENCH_BATCH", "1024"))
    with tempfile.TemporaryDirectory() as tmp:
        data = write_dataset(tmp, n_reads)
        fq = data["fastq"]
        layout = SequenceLayout.from_yaml(data["layout"])
        rm = ReferenceManager.from_layout(layout)
        log("dataset written; warming up (compiles device kernels)")

        # warm-up: compile the device kernels on a prefix long enough to
        # hit the full-batch shape and the remainder shapes of one flush
        warm = os.path.join(tmp, "warm.fastq")
        with open(fq) as src, open(warm, "w") as dst:
            for _ in range(4 * 8704):
                line = src.readline()
                if not line:
                    break
                dst.write(line)
        warm_sink = CollapseSink(layout, rm)
        align_reads(layout, rm, os.path.join(tmp, "warm.bam"), read1=warm,
                    batch_size=batch, sink=warm_sink)
        # warm the collapse correction kernels (device distance matmuls)
        collapse_from_reads(os.path.join(tmp, "warm_collapsed.bam"), layout,
                            rm, warm_sink.finish(), warm_sink.stats)
        log("warmup done; timing main run")

        from clique_tpu.caller.events import call_events_from_records

        t0 = time.time()
        align_metrics = os.path.join(tmp, "align_metrics.json")
        sink = CollapseSink(layout, rm)
        stats = align_reads(layout, rm, os.path.join(tmp, "out.bam"),
                            read1=fq, batch_size=batch,
                            metrics_path=align_metrics, sink=sink)
        align_dt = time.time() - t0
        log(f"align done in {align_dt:.1f}s")
        device_s = None
        try:
            with open(align_metrics) as fh:
                am = json.load(fh)
            device_s = am.get("device_seconds")
            log(f"align breakdown: device {am.get('device_seconds')}s, "
                f"host-post {am.get('host_post_seconds')}s, "
                f"cells/s {am.get('dp_cells_per_s')}")
            log(f"align phase walls: {am.get('phase_walls')}")
        except OSError:
            pass
        t0 = time.time()
        reads_by_ref = sink.finish()
        collapsed = os.path.join(tmp, "collapsed.bam")
        tap = []
        collapse_from_reads(collapsed, layout, rm, reads_by_ref, sink.stats,
                            n_passing=sink.n_passing,
                            ingest_seconds=sink.seconds, record_tap=tap)
        collapse_dt = time.time() - t0
        log(f"collapse done in {collapse_dt:.1f}s (fused; sink ingest ran "
            f"inside align wall: {sink.seconds:.2f}s)")
        try:
            with open(collapsed + ".collapse_metrics.json") as fh:
                m = json.load(fh)
            log(f"collapse breakdown: ingest {m.get('ingest_s')}s "
                f"(overlapped), levels {m.get('levels_s')}s, "
                f"outputs {m.get('outputs_s')}s")
            for rname, rmet in m.get("references", {}).items():
                if rmet.get("output_phases"):
                    log(f"output phases [{rname}]: "
                        f"{rmet['output_phases']}")
        except OSError:
            pass
        t0 = time.time()
        alleles = os.path.join(tmp, "alleles.tsv")
        call_events_from_records(layout, tap, alleles, min_read_count=1)
        call_dt = time.time() - t0
        dt = align_dt + collapse_dt + call_dt
        log(f"call done in {call_dt:.1f}s; chain {dt:.1f}s")

    reads_per_s = stats.aligned / dt
    ref_len = len(data["ref_seq"])
    read_len = data["read_len"]
    n_cells = data["n_cells"]
    # Baseline: MEASURED when a C compiler exists — native/refdp.c runs
    # the reference's 3-plane fill+traceback recurrence per read AND a
    # collapse-stage model (extraction walk + unique-tag clustering +
    # stretcher column consensus, the collapse.rs/consensus_builders.rs
    # hot loops) on THIS host, threads fanned like its rayon pool (the
    # Rust crate itself cannot build here: no cargo, zero egress). Falls
    # back to a labeled align-anchored model without a compiler.
    baseline = None
    try:
        from clique_tpu.native import measure_reference_chain

        baseline = measure_reference_chain(
            l1=ref_len, l2=read_len, n_reads=n_reads, n_cells=n_cells,
            sample_reads=128)
    except Exception as exc:
        log(f"C baseline unavailable ({exc}); using model fallback")
    if baseline:
        rust_estimate = baseline["chain_reads_per_s"]
        basis = (f"measured_c_chain_same_host (align "
                 f"{baseline['align_mcells_per_s']:.0f} Mcells/s, collapse "
                 f"pass measured {baseline['collapse_s']:.2f}s/{n_reads} "
                 f"reads, {os.cpu_count()} threads)")
    else:
        cells_per_read = 3 * ref_len * read_len
        rust_estimate = 8e8 / cells_per_read / 2.5
        basis = ("model_100Mcells_per_core_x8_align_anchored "
                 "(collapse factor 2.5 asserted, not measured)")
    print(json.dumps({
        "metric": "align_collapse_call_reads_per_s_per_chip",
        "value": round(reads_per_s, 1),
        "unit": "reads/s/chip",
        "vs_baseline": round(reads_per_s / rust_estimate, 2),
        "vs_baseline_basis": basis,
        "align_s": round(align_dt, 2),
        "collapse_s": round(collapse_dt, 2),
        "call_s": round(call_dt, 2),
        # host-clock share of the align wall spent dispatching and
        # syncing (not a device trace)
        "host_dispatch_sync_frac": round(device_s / align_dt, 3)
        if device_s and align_dt else None,
        "device": {k: report[k] for k in ("platform", "kind", "count")},
        "gpu": report["gpu"],
    }))


if __name__ == "__main__":
    main()
