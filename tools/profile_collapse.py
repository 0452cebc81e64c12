#!/usr/bin/env python
"""Host-side collapse profiler: synthesizes the bench dataset's aligned BAM
directly (bench reads are substitution-only, all-M CIGARs) and runs
collapse under cProfile on the CPU backend. The device distance calls run
on CPU jax here, so treat device time as noise and read the HOST lines.

Usage: ./run_tests.sh is NOT needed; run with
  JAX_PLATFORMS=cpu python tools/profile_collapse.py [--ooc]
"""

import cProfile
import io
import os
import pstats
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build(tmp):
    from clique_tpu.config.layout import SequenceLayout
    from clique_tpu.io.sam import BamWriter, SamRecord

    rng = np.random.default_rng(2026)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    a5 = "TTCAGACGTGTGCTCTTCCGATCT"
    a3 = "AGATCGGAAGAGCACACGTCTGAA"
    targets = [rng.choice(bases, 20).tobytes().decode() + "TGG"
               for _ in range(10)]
    target_block = "GAAA".join(targets)
    ref_seq = f"{a5}{'0' * 16}{'1' * 12}{target_block}{a3}"
    layout_path = os.path.join(tmp, "layout.yaml")
    with open(layout_path, "w") as fh:
        fh.write(f"""
known_strand: true
reads:
  - !Read1
    orientation: Forward
references:
  amplicon1:
    sequence: "{ref_seq}"
    umi_configurations:
      cell_id: {{symbol: '0', sort_type: "DegenerateTag", length: 16, order: 0, max_distance: 2}}
      cell_umi: {{symbol: '1', sort_type: "DegenerateTag", length: 12, order: 1, max_distance: 2}}
""")
    n_reads = int(os.environ.get("N", "20000"))
    base_read = np.frombuffer(
        (a5 + "N" * 28 + target_block + a3).encode(), dtype=np.uint8)
    L = len(base_read)
    n_cells = 500
    cells = rng.choice(bases, (n_cells, 16))
    umis = rng.choice(bases, (n_cells, 4, 12))
    bam = os.path.join(tmp, "aligned.bam")
    with BamWriter(bam, [("amplicon1", L)]) as w:
        batch = []
        for i in range(n_reads):
            c = i % n_cells
            read = base_read.copy()
            read[24:40] = cells[c]
            read[40:52] = umis[c, (i // n_cells) % 4]
            subs = rng.random(L) < 0.05
            read[subs] = rng.choice(bases, int(subs.sum()))
            batch.append(SamRecord(
                name=f"r{i}", flag=0, reference_name="amplicon1", pos=1,
                mapq=255, cigar=[(L, "M")], seq=read.tobytes(),
                qual=b"I" * L, tags={"rc": "1"}))
            if len(batch) >= 2048:
                w.write_batch(batch)
                batch = []
        w.write_batch(batch)
    return layout_path, bam


def main():
    from clique_tpu.collapse.pipeline import collapse
    from clique_tpu.config.layout import SequenceLayout

    ooc = "--ooc" in sys.argv
    n_workers = 1
    for a in sys.argv[1:]:
        if a.startswith("--workers="):
            n_workers = int(a.split("=", 1)[1])
    with tempfile.TemporaryDirectory() as tmp:
        layout_path, bam = build(tmp)
        layout = SequenceLayout.from_yaml(layout_path)
        out = os.path.join(tmp, "collapsed.bam")
        t0 = time.time()
        prof = cProfile.Profile()
        prof.enable()
        collapse(out, layout, bam, temp_dir=tmp, out_of_core=ooc,
                 n_workers=n_workers)
        prof.disable()
        print(f"collapse wall: {time.time() - t0:.2f}s (ooc={ooc})",
              file=sys.stderr)
        import json
        with open(out + ".collapse_metrics.json") as fh:
            m = json.load(fh)
        print(f"ingest {m['ingest_s']}s levels {m['levels_s']}s "
              f"outputs {m['outputs_s']}s", file=sys.stderr)
        s = io.StringIO()
        stats = pstats.Stats(prof, stream=s)
        stats.sort_stats("cumulative").print_stats(35)
        print(s.getvalue())


if __name__ == "__main__":
    main()
