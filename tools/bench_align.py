#!/usr/bin/env python
"""Align-only throughput driver.

Same dataset shape as bench.py (600bp 10-target amplicon, 5% subs) but
align_reads only; prints reads/s (tools/ab_fill.py compares the fills).

    python tools/bench_align.py [n_reads]
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import numpy as np

    from clique_tpu.utils.jaxcfg import enable_persistent_cache
    enable_persistent_cache()

    from clique_tpu.align.pipeline import align_reads
    from clique_tpu.config.layout import SequenceLayout
    from clique_tpu.reference.manager import ReferenceManager

    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 20000
    rng = np.random.default_rng(2026)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    a5 = "TTCAGACGTGTGCTCTTCCGATCT"
    a3 = "AGATCGGAAGAGCACACGTCTGAA"
    targets = [rng.choice(bases, 20).tobytes().decode() + "TGG"
               for _ in range(10)]
    target_block = "GAAA".join(targets)
    ref_seq = f"{a5}{'0' * 16}{'1' * 12}{target_block}{a3}"

    with tempfile.TemporaryDirectory() as tmp:
        layout_path = os.path.join(tmp, "layout.yaml")
        tl = ", ".join(f'"{t}"' for t in targets)
        ty = ", ".join('"Cas9WT"' for _ in targets)
        with open(layout_path, "w") as fh:
            fh.write(f"""
known_strand: true
reads:
  - !Read1
    orientation: Forward
references:
  amplicon1:
    sequence: "{ref_seq}"
    targets: [{tl}]
    target_types: [{ty}]
    umi_configurations:
      cell_id: {{symbol: '0', sort_type: "DegenerateTag", length: 16, order: 0, max_distance: 2}}
      cell_umi: {{symbol: '1', sort_type: "DegenerateTag", length: 12, order: 1, max_distance: 2}}
""")
        fq = os.path.join(tmp, "reads.fastq")
        base_read = np.frombuffer(
            (a5 + "N" * 28 + target_block + a3).encode(), dtype=np.uint8)
        L = len(base_read)
        with open(fq, "w") as fh:
            for i in range(n_reads):
                read = base_read.copy()
                read[24:52] = rng.choice(bases, 28)
                subs = rng.random(L) < 0.05
                read[subs] = rng.choice(bases, int(subs.sum()))
                fh.write(f"@r{i}\n{read.tobytes().decode()}\n+\n{'I' * L}\n")

        layout = SequenceLayout.from_yaml(layout_path)
        rm = ReferenceManager.from_layout(layout)

        warm = os.path.join(tmp, "warm.fastq")
        with open(fq) as src, open(warm, "w") as dst:
            for _ in range(4 * 512):
                line = src.readline()
                if not line:
                    break
                dst.write(line)
        align_reads(layout, rm, os.path.join(tmp, "warm.bam"), read1=warm,
                    batch_size=512)

        t0 = time.time()
        stats = align_reads(layout, rm, os.path.join(tmp, "out.bam"),
                            read1=fq, batch_size=512,
                            metrics_path=os.path.join(tmp, "m.json"))
        dt = time.time() - t0
        with open(os.path.join(tmp, "m.json")) as fh:
            import json
            m = json.load(fh)
    print(f"aligned={stats.aligned} {dt:.2f}s "
          f"{stats.aligned / dt:.0f} reads/s  device={m['device_seconds']:.2f}s "
          f"host_post={m['host_post_seconds']:.2f}s "
          f"dp={m['dp_cells_per_s'] / 1e9:.1f} Gcells/s")


if __name__ == "__main__":
    main()
