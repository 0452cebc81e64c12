#!/usr/bin/env python
"""Mint the vendored golden pipeline artifacts (tests/data/golden/).

The golden pin (tests/test_golden_pin.py) asserts the DEFAULT pipeline's
BAM output is byte-stable: any drift in alignment, extraction, correction,
consensus, or BAM encoding fails the test (BASELINE "bit-for-bit" clause,
VERDICT r2 item 8). Re-run this script ONLY when an intentional behavior
change invalidates the pin, and say so in the commit message:

    JAX_PLATFORMS=cpu python tools/make_golden.py

Dataset: one GESTALT-style amplicon, a 2-level hierarchy (cell_id
KnownTag against a frozen 8-barcode allowlist + umi DegenerateTag), 48
reads over 6 cells with seeded substitutions/indels including barcode
errors within correction distance — enough to exercise align, extraction,
known-list correction, degenerate clustering, and consensus.
"""

import gzip
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
GOLDEN = os.path.join(ROOT, "tests", "data", "golden")

A5 = "TTCAGACGTGTGCTCTTCCGATCT"
A3 = "AGATCGGAAGAGCACACGTCTGAA"
TARGETS = ["ACGTAACGTAACGTAACGTACGG", "TGCATGCAATGCATGCAATGTGG"]
REF_SEQ = (A5 + "0" * 16 + "1" * 12 + TARGETS[0] + "GAAA" + TARGETS[1]
           + A3)

LAYOUT_TEMPLATE = f"""known_strand: true
reads:
  - !Read1
    orientation: Forward
references:
  amp1:
    sequence: "{REF_SEQ}"
    targets: ["{TARGETS[0]}", "{TARGETS[1]}"]
    target_types: ["Cas9WT", "Cas9WT"]
    umi_configurations:
      cell_id:
        symbol: '0'
        file: "@ALLOWLIST@"
        sort_type: "KnownTag"
        length: 16
        order: 0
        max_distance: 2
        levenshtein_distance: false
      umi:
        symbol: '1'
        sort_type: "DegenerateTag"
        length: 12
        order: 1
        max_distance: 2
"""


def write_inputs(target_dir: str = GOLDEN):
    """Mint the deterministic inputs into target_dir.

    target_dir defaults to the vendored fixtures dir; tests pass a
    tmp_path and byte-compare against the vendored files instead of
    rewriting them (so a drifting generator fails loudly without leaving
    a dirty tree whose fixtures no longer match the pinned outputs)."""
    os.makedirs(target_dir, exist_ok=True)
    rng = np.random.default_rng(20260818)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)

    allow = [rng.choice(bases, 16).tobytes().decode() for _ in range(8)]
    with open(os.path.join(target_dir, "allowlist.txt"), "w") as fh:
        fh.write("\n".join(allow) + "\n")

    with open(os.path.join(target_dir, "layout.yaml.in"), "w") as fh:
        fh.write(LAYOUT_TEMPLATE)

    n_cells = 6
    umis = [[rng.choice(bases, 12).tobytes().decode() for _ in range(2)]
            for _ in range(n_cells)]
    cut = REF_SEQ.index(TARGETS[0]) + 14  # Cas9 window
    records = []
    i = 0
    for c in range(n_cells):
        for u in range(2):
            for k in range(4):
                read = REF_SEQ.replace("0" * 16, allow[c]).replace(
                    "1" * 12, umis[c][u])
                if c % 2 == 0:
                    # edited cells: 3bp deletion at the cut site
                    read = read[:cut] + read[cut + 3:]
                arr = np.frombuffer(read.encode(), np.uint8).copy()
                subs = rng.random(len(arr)) < 0.02
                arr[subs] = rng.choice(bases, int(subs.sum()))
                if k == 3:
                    # one read per group with a barcode error (1 sub in
                    # the cell zone) to exercise known-list correction
                    arr[24 + int(rng.integers(16))] = rng.choice(bases)
                records.append((f"g{i}", arr.tobytes().decode()))
                i += 1
    # mtime=0 keeps the .gz byte-stable across regenerations
    raw = "".join(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n"
                  for name, seq in records).encode()
    with open(os.path.join(target_dir, "reads.fastq.gz"), "wb") as out:
        with gzip.GzipFile(fileobj=out, mode="wb", mtime=0) as fh:
            fh.write(raw)


GOLDEN_PE = os.path.join(ROOT, "tests", "data", "golden_pe")

PE_LAYOUT_TEMPLATE = f"""known_strand: true
merge: "Align"
reads:
  - !Read1
    orientation: Forward
  - !Read2
    orientation: Forward
references:
  amp1:
    sequence: "{REF_SEQ}"
    targets: ["{TARGETS[0]}", "{TARGETS[1]}"]
    target_types: ["Cas9WT", "Cas9WT"]
    umi_configurations:
      cell_id:
        symbol: '0'
        file: "@ALLOWLIST@"
        sort_type: "KnownTag"
        length: 16
        order: 0
        max_distance: 2
        levenshtein_distance: false
      umi:
        symbol: '1'
        sort_type: "DegenerateTag"
        length: 12
        order: 1
        max_distance: 2
"""


def write_pe_inputs(target_dir: str = GOLDEN_PE):
    """Mint the paired-end golden inputs (VERDICT r3 item 8: the byte
    pin must also cover the merger path — merger.rs:348
    merge_reads_by_alignment overlap consensus with PHRED combination).

    Same amplicon and 2-level hierarchy as the single-end golden, but
    each read arrives as an R1/R2 pair: R1 = the first 80bp at high
    quality, R2 = revcomp of the last 80bp at lower quality, overlapping
    in the middle so the Align merge strategy must reconstruct the full
    read, resolve overlap disagreements by quality, and combine agreeing
    PHREDs."""
    from clique_tpu.utils.seq import reverse_complement

    os.makedirs(target_dir, exist_ok=True)
    rng = np.random.default_rng(20260819)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)

    allow = [rng.choice(bases, 16).tobytes().decode() for _ in range(6)]
    with open(os.path.join(target_dir, "allowlist.txt"), "w") as fh:
        fh.write("\n".join(allow) + "\n")
    with open(os.path.join(target_dir, "layout.yaml.in"), "w") as fh:
        fh.write(PE_LAYOUT_TEMPLATE)

    n_cells = 4
    umis = [[rng.choice(bases, 12).tobytes().decode() for _ in range(2)]
            for _ in range(n_cells)]
    cut = REF_SEQ.index(TARGETS[0]) + 14
    r1_records, r2_records = [], []
    i = 0
    for c in range(n_cells):
        for u in range(2):
            for k in range(3):
                read = REF_SEQ.replace("0" * 16, allow[c]).replace(
                    "1" * 12, umis[c][u])
                if c % 2 == 0:
                    read = read[:cut] + read[cut + 3:]
                arr = np.frombuffer(read.encode(), np.uint8).copy()
                subs = rng.random(len(arr)) < 0.01
                arr[subs] = rng.choice(bases, int(subs.sum()))
                full = arr.tobytes().decode()
                r1 = full[:80]
                r2 = reverse_complement(full[-80:].encode()).decode()
                if k == 2:
                    # one disagreeing base inside the overlap zone on the
                    # LOW-quality mate: the merge must keep R1's call
                    # (merger.rs:470-490 higher-quality base wins)
                    pos = len(full) - 80 + 10   # inside R2, overlap zone
                    r2l = list(r2)
                    r2pos = len(full) - pos - 1  # revcomp coordinate
                    r2l[r2pos] = {"A": "C", "C": "G", "G": "T",
                                  "T": "A"}[r2l[r2pos]]
                    r2 = "".join(r2l)
                r1_records.append((f"p{i}", r1, "I" * len(r1)))
                r2_records.append((f"p{i}", r2, "5" * len(r2)))
                i += 1
    for name, records in (("reads1.fastq.gz", r1_records),
                          ("reads2.fastq.gz", r2_records)):
        raw = "".join(f"@{nm}\n{seq}\n+\n{q}\n"
                      for nm, seq, q in records).encode()
        with open(os.path.join(target_dir, name), "wb") as out:
            with gzip.GzipFile(fileobj=out, mode="wb", mtime=0) as fh:
                fh.write(raw)


GOLDEN_ML = os.path.join(ROOT, "tests", "data", "golden_ml")

# The mouse-lineage 3-level config (VERDICT r4 item 7): shaped exactly
# like rust_cmd/mouse_lineage_test/maryam_fwd_both.yaml — the OLDER YAML
# schema (top-level umi_configurations, known_orientation, bare READ1
# items, ConcatenateBothForward merge) with its 3-level hierarchy:
# KnownTag(levenshtein trie closer) 16bp cell_id + Degenerate 12bp
# cell_umi (max_distance 1) + Degenerate 12bp static_id. The reference's
# current serde types reject this schema; ours loads it
# (config/layout.py:143-207), and this golden pins the whole chain on it.
# The 10X-style amplicon: R1 carries cell+UMI, R2 carries the static
# integration id between fixed flanks.
ML_LINK = "ACCGGTTCAGACGTACTGAGCTTGCCAGTA"
ML_TAIL = "GGCTTAAGCCGGAACTCTGCAGGTCCAATG"
ML_REF_SEQ = "0" * 16 + "1" * 12 + ML_LINK + "2" * 12 + ML_TAIL

ML_LAYOUT_TEMPLATE = f"""---
merge: "ConcatenateBothForward"
known_orientation: true
sequence: "{ML_REF_SEQ}"
reads:
  - READ1
  - READ2
umi_configurations:
  cell_id:
    symbol: '0'
    sort_type: "KnownTag"
    file: "@ALLOWLIST@"
    length: 16
    order: 0
    max_distance: 2
  cell_umi:
    symbol: '1'
    sort_type: "DegenerateTag"
    length: 12
    order: 1
    max_distance: 1
    maximum_subsequences: 250000
  static_id:
    symbol: '2'
    sort_type: "DegenerateTag"
    length: 12
    order: 2
    max_distance: 2
    maximum_subsequences: 50000
"""


def write_ml_inputs(target_dir: str = GOLDEN_ML):
    """Mint the mouse-lineage golden inputs: 6 cells (from an 8-barcode
    allowlist) x 2 UMIs x 8 reads, one static integration id per cell.
    Per (cell, umi) group: 5 clean reads, one with a 1-sub cell-barcode
    error (trie/levenshtein closer, distance <= 2), one with a 1-sub UMI
    error (degenerate absorption at max_distance 1 — count 1 vs 7
    clears the ratio-5 bar), one with a 1-sub static-id error (ratio
    absorption at the third level). The collapsed BAM must therefore
    hold exactly 12 consensus records of rc=8."""
    os.makedirs(target_dir, exist_ok=True)
    rng = np.random.default_rng(20260820)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)

    allow = [rng.choice(bases, 16).tobytes().decode() for _ in range(8)]
    with open(os.path.join(target_dir, "allowlist.txt"), "w") as fh:
        fh.write("\n".join(allow) + "\n")
    with open(os.path.join(target_dir, "layout.yaml.in"), "w") as fh:
        fh.write(ML_LAYOUT_TEMPLATE)

    n_cells = 6
    umis = [[rng.choice(bases, 12).tobytes().decode() for _ in range(2)]
            for _ in range(n_cells)]
    statics = [rng.choice(bases, 12).tobytes().decode()
               for _ in range(n_cells)]

    def _mut1(s: str, pos: int) -> str:
        alt = {"A": "C", "C": "G", "G": "T", "T": "A"}
        return s[:pos] + alt[s[pos]] + s[pos + 1:]

    r1_records, r2_records = [], []
    i = 0
    for c in range(n_cells):
        for u in range(2):
            for k in range(8):
                cell, umi, stat = allow[c], umis[c][u], statics[c]
                if k == 5:
                    # in-distance cell-barcode error (trie closer d<=2)
                    cell = _mut1(cell, int(rng.integers(16)))
                if k == 6:
                    # in-distance UMI error (max_distance 1); count 1 vs
                    # the true UMI's 7 clears the ratio-5 absorption bar
                    umi = _mut1(umi, int(rng.integers(12)))
                if k == 7:
                    # static-id error absorbed at the third level
                    stat = _mut1(stat, int(rng.integers(12)))
                r1 = cell + umi
                r2 = ML_LINK + stat + ML_TAIL
                r1_records.append((f"m{i}", r1, "I" * len(r1)))
                r2_records.append((f"m{i}", r2, "F" * len(r2)))
                i += 1
    for name, records in (("reads1.fastq.gz", r1_records),
                          ("reads2.fastq.gz", r2_records)):
        raw = "".join(f"@{nm}\n{seq}\n+\n{q}\n"
                      for nm, seq, q in records).encode()
        with open(os.path.join(target_dir, name), "wb") as out:
            with gzip.GzipFile(fileobj=out, mode="wb", mtime=0) as fh:
                fh.write(raw)


def run_ml_pipeline(workdir):
    """Mouse-lineage chain: legacy-schema layout -> concatenate-merge
    align -> 3-level collapse (trie known-list + two degenerate levels).
    No targets in the layout (like maryam_fwd_both.yaml), so there is no
    call stage."""
    from clique_tpu.align.pipeline import align_reads
    from clique_tpu.collapse.pipeline import collapse

    layout, rm = _load_layout(workdir, golden_dir=GOLDEN_ML)
    aligned = os.path.join(workdir, "aligned.bam")
    align_reads(layout, rm, aligned,
                read1=os.path.join(GOLDEN_ML, "reads1.fastq.gz"),
                read2=os.path.join(GOLDEN_ML, "reads2.fastq.gz"),
                batch_size=16)
    collapsed = os.path.join(workdir, "collapsed.bam")
    collapse(collapsed, layout, aligned)
    return aligned, collapsed, None


def _load_layout(workdir, name="layout.yaml", golden_dir=None):
    """Template the frozen layout (allowlist path substituted) and parse
    it, returning (layout, ReferenceManager)."""
    from clique_tpu.config.layout import SequenceLayout
    from clique_tpu.reference.manager import ReferenceManager

    gd = golden_dir or GOLDEN
    layout_path = os.path.join(workdir, name)
    with open(os.path.join(gd, "layout.yaml.in")) as fh:
        text = fh.read().replace(
            "@ALLOWLIST@", os.path.join(gd, "allowlist.txt"))
    with open(layout_path, "w") as fh:
        fh.write(text)
    layout = SequenceLayout.from_yaml(layout_path)
    return layout, ReferenceManager.from_layout(layout)


def run_pipeline(workdir):
    from clique_tpu.align.pipeline import align_reads
    from clique_tpu.caller.events import call_events_from_bam
    from clique_tpu.collapse.pipeline import collapse

    layout, rm = _load_layout(workdir)
    aligned = os.path.join(workdir, "aligned.bam")
    align_reads(layout, rm, aligned,
                read1=os.path.join(GOLDEN, "reads.fastq.gz"), batch_size=16)
    collapsed = os.path.join(workdir, "collapsed.bam")
    collapse(collapsed, layout, aligned)
    alleles = os.path.join(workdir, "alleles.tsv")
    call_events_from_bam(layout, collapsed, alleles, min_read_count=1)
    return aligned, collapsed, alleles


def run_pe_pipeline(workdir):
    """Paired-end align (merge Align) -> collapse -> call on the
    golden_pe inputs."""
    from clique_tpu.align.pipeline import align_reads
    from clique_tpu.caller.events import call_events_from_bam
    from clique_tpu.collapse.pipeline import collapse

    layout, rm = _load_layout(workdir, golden_dir=GOLDEN_PE)
    aligned = os.path.join(workdir, "aligned.bam")
    align_reads(layout, rm, aligned,
                read1=os.path.join(GOLDEN_PE, "reads1.fastq.gz"),
                read2=os.path.join(GOLDEN_PE, "reads2.fastq.gz"),
                batch_size=16)
    collapsed = os.path.join(workdir, "collapsed.bam")
    collapse(collapsed, layout, aligned)
    alleles = os.path.join(workdir, "alleles.tsv")
    call_events_from_bam(layout, collapsed, alleles, min_read_count=1)
    return aligned, collapsed, alleles


def run_inversion(workdir):
    """Inversion-path byte pin (VERDICT r3 item 8): the anchored +
    inversion-aware alignment of the vendored big-inversion fixture
    (linked_alignment.rs:619-689), dumped as a TSV artifact. Pinned at
    the alignment level, NOT as BAM: the reference itself panics when
    converting InversionOpen/Close to SAM ops (alignment_matrix.rs:
    103-104), so no BAM representation exists to pin against."""
    from clique_tpu.align.anchored import align_string_with_anchors
    from clique_tpu.align.scoring import AffineScoring, InversionScoring
    from clique_tpu.reference.manager import (
        SeedIndex,
        find_greedy_non_overlapping_segments,
    )

    data = os.path.join(ROOT, "tests", "data")
    ref = open(os.path.join(data, "big_inversion_ref.txt")).read().encode()
    read = open(os.path.join(data, "big_inversion_read.txt")).read().encode()
    aff = AffineScoring(10.0, -11.0, 8.0, -15.0, -5.0, 1.0)
    inv = InversionScoring(10.0, -11.0, -15.0, -5.0, -2.0, 20)
    idx = SeedIndex(ref, 20)
    segs = find_greedy_non_overlapping_segments(read, ref, idx)
    res = align_string_with_anchors("read", "ref", read, ref, segs,
                                    inv, aff)
    out = os.path.join(workdir, "inversion.tsv")
    cig = "".join(f"{c}{op}" if op not in "<>" else op
                  for c, op in res.cigar)
    with open(out, "w") as fh:
        fh.write("cigar\tscore\treference_aligned\tread_aligned\n")
        fh.write(f"{cig}\t{res.score}\t"
                 f"{res.reference_aligned.decode()}\t"
                 f"{res.read_aligned.decode()}\n")
    return out


def run_engine(workdir, engine):
    """Align-only run under a non-default engine (wfa/convex) for the
    per-engine byte pins."""
    from clique_tpu.align.pipeline import align_reads

    layout, rm = _load_layout(workdir, f"layout_{engine}.yaml")
    out = os.path.join(workdir, f"aligned_{engine}.bam")
    align_reads(layout, rm, out,
                read1=os.path.join(GOLDEN, "reads.fastq.gz"),
                batch_size=16, engine=engine)
    return out


def dump_tags(bam_path, out_path):
    """Deterministic per-record tag dump: name, ref, pos, cigar, seq,
    sorted tags."""
    from clique_tpu.io.sam import BamReader

    with BamReader(bam_path) as reader, open(out_path, "w") as out:
        for rec in reader:
            cig = "".join(f"{n}{op}" for n, op in rec.cigar)
            tags = ";".join(f"{k}={v}" for k, v in sorted(rec.tags.items()))
            out.write(f"{rec.name}\t{rec.reference_name}\t{rec.pos}\t"
                      f"{cig}\t{rec.seq.decode()}\t{tags}\n")


def _copy_outputs(golden_dir, bam_outputs, alleles):
    for src, name in bam_outputs:
        with open(src, "rb") as fh:
            data = fh.read()
        with open(os.path.join(golden_dir, name), "wb") as fh:
            fh.write(data)
        dump_tags(src, os.path.join(golden_dir, name + ".tags.tsv"))
    if alleles is not None:
        with open(alleles) as fh:
            table = fh.read()
        with open(os.path.join(golden_dir, "alleles.tsv"), "w") as fh:
            fh.write(table)


def main():
    import shutil
    import tempfile

    write_inputs()
    write_pe_inputs()
    with tempfile.TemporaryDirectory() as tmp:
        aligned, collapsed, alleles = run_pipeline(tmp)
        outputs = [(aligned, "aligned.bam"), (collapsed, "collapsed.bam")]
        for engine in ("wfa", "convex"):
            outputs.append((run_engine(tmp, engine),
                            f"aligned_{engine}.bam"))
        _copy_outputs(GOLDEN, outputs, alleles)
        shutil.copy(run_inversion(tmp), os.path.join(GOLDEN,
                                                     "inversion.tsv"))
    with tempfile.TemporaryDirectory() as tmp:
        aligned, collapsed, alleles = run_pe_pipeline(tmp)
        _copy_outputs(GOLDEN_PE,
                      [(aligned, "aligned.bam"),
                       (collapsed, "collapsed.bam")], alleles)
    write_ml_inputs()
    with tempfile.TemporaryDirectory() as tmp:
        aligned, collapsed, _none = run_ml_pipeline(tmp)
        _copy_outputs(GOLDEN_ML,
                      [(aligned, "aligned.bam"),
                       (collapsed, "collapsed.bam")], None)
    print(f"golden artifacts written to {GOLDEN}, {GOLDEN_PE} "
          f"and {GOLDEN_ML}")


if __name__ == "__main__":
    main()
