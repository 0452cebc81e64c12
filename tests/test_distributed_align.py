"""Multi-host align: N jax.distributed processes striping FASTQ read
chunks must produce the SAME record multiset as single-process
align_reads (SURVEY 2.11 P1 — "FASTQ shards stream data-parallel, one
shard set per host"; the rayon fanout of alignment_functions.rs:90-93).
The two-process test runs the FULL north-star chain: distributed align ->
distributed collapse, compared against the single-host chain."""

import os
import socket
import subprocess
import sys
import textwrap

from clique_tpu.align.pipeline import align_reads
from clique_tpu.collapse.pipeline import collapse
from clique_tpu.io.sam import BamReader, BamWriter, concat_bam_parts
from clique_tpu.io.sam import SamRecord

from tests.test_distributed_collapse import build_dataset, record_multiset


def _mk_record(name, ref, pos, seq):
    return SamRecord(name=name, flag=0, reference_name=ref, pos=pos,
                     mapq=40, cigar=[(len(seq), "M")], seq=seq,
                     qual=b"I" * len(seq), tags={"ar": name})


def test_concat_bam_parts(tmp_path):
    refs = [("amp1", 100)]
    parts = []
    for p, names in enumerate((["a", "b"], [], ["c"])):
        path = str(tmp_path / f"part{p}.bam")
        with BamWriter(path, refs) as w:
            for i, n in enumerate(names):
                w.write(_mk_record(n, "amp1", i + 1, b"ACGTACGT"))
        parts.append(path)
    out = str(tmp_path / "merged.bam")
    concat_bam_parts(out, refs, parts)
    with BamReader(out) as reader:
        got = [(r.name, r.pos, r.seq) for r in reader]
    assert got == [("a", 1, b"ACGTACGT"), ("b", 2, b"ACGTACGT"),
                   ("c", 1, b"ACGTACGT")]


def test_align_distributed_single_process(tmp_path):
    from clique_tpu.parallel.distributed import align_distributed
    from clique_tpu.config.layout import SequenceLayout
    from clique_tpu.reference.manager import ReferenceManager

    layout, layout_path, aligned = build_dataset(tmp_path)
    rm = ReferenceManager.from_layout(layout)
    fq = str(tmp_path / "reads.fastq.gz")
    out = str(tmp_path / "dist_align1.bam")
    align_distributed(layout, rm, out, str(tmp_path / "workA"),
                      read1=fq, process_id=0, num_processes=1, batch_size=8)
    assert record_multiset(out) == record_multiset(aligned)


# worker processes import clique_tpu from the repo root (not installed)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import sys
    (layout_path, fq, work, out_bam, cwork, cout,
     pid, nproc, port) = sys.argv[1:10]
    from clique_tpu.config.layout import SequenceLayout
    from clique_tpu.reference.manager import ReferenceManager
    from clique_tpu.parallel.distributed import (align_distributed,
                                                 collapse_distributed)
    layout = SequenceLayout.from_yaml(layout_path)
    rm = ReferenceManager.from_layout(layout)
    align_distributed(layout, rm, out_bam, work, read1=fq,
                      process_id=int(pid), num_processes=int(nproc),
                      coordinator_address=f"localhost:{port}",
                      batch_size=8)
    # chain straight into distributed collapse on the merged BAM: the
    # full multi-host align -> collapse path in one process set
    collapse_distributed(cout, layout, out_bam, cwork,
                         process_id=int(pid), num_processes=int(nproc))
""")


def test_align_distributed_resume_skips_complete_part(tmp_path):
    """Part BAMs are resume points: a rerun with a complete part skips
    its alignment (the part file is untouched); an interrupted part
    (truncated, no valid cqi sentinel) is redone."""
    from clique_tpu.config.layout import SequenceLayout
    from clique_tpu.parallel.distributed import align_distributed
    from clique_tpu.reference.manager import ReferenceManager

    layout, _lp, aligned = build_dataset(tmp_path)
    rm = ReferenceManager.from_layout(layout)
    fq = str(tmp_path / "reads.fastq.gz")
    work = tmp_path / "wkr"
    out = str(tmp_path / "resume.bam")
    align_distributed(layout, rm, out, str(work), read1=fq,
                      process_id=0, num_processes=1, batch_size=8)
    part = work / "part.p0.bam"
    before = part.stat().st_mtime_ns
    stats2 = align_distributed(layout, rm, out, str(work), read1=fq,
                               process_id=0, num_processes=1, batch_size=8)
    assert stats2 is None                       # resumed, no re-align
    assert part.stat().st_mtime_ns == before    # part untouched
    assert record_multiset(out) == record_multiset(aligned)

    # truncate the part (simulate a crash mid-write): it must be redone
    raw = part.read_bytes()
    part.write_bytes(raw[:len(raw) // 2])
    stats3 = align_distributed(layout, rm, out, str(work), read1=fq,
                               process_id=0, num_processes=1, batch_size=8)
    assert stats3 is not None
    assert record_multiset(out) == record_multiset(aligned)

    # changed input (new mtime/size signature): stale part must be redone
    # even though it is internally complete
    import gzip as _gzip
    import os as _os

    data = _gzip.open(fq).read()
    with _gzip.open(fq, "wb") as fh:
        fh.write(data)
    _os.utime(fq, (0, 0))
    stats4 = align_distributed(layout, rm, out, str(work), read1=fq,
                               process_id=0, num_processes=1, batch_size=8)
    assert stats4 is not None


def test_align_distributed_paired_end(tmp_path):
    """Paired-end (R1+R2 align-merge) striping goes through the general
    reader loop: 1-process distributed == plain align_reads on merged
    pairs."""
    import gzip

    import numpy as np

    from clique_tpu.config.layout import SequenceLayout
    from clique_tpu.parallel.distributed import align_distributed
    from clique_tpu.reference.manager import ReferenceManager
    from clique_tpu.utils.seq import reverse_complement

    rng = np.random.default_rng(88)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    a5 = "TTCAGACGTGTGCTCTTCCGATCT"
    a3 = "AGATCGGAAGAGCACACGTCTGAA"
    amp = a5 + "".join("ACGT"[i] for i in rng.integers(0, 4, 52)) + a3
    layout_path = tmp_path / "layout.yaml"
    layout_path.write_text(f"""
known_strand: true
merge: Align
reads:
  - !Read1
    orientation: Forward
  - !Read2
    orientation: Reverse
references:
  amp1:
    sequence: "{amp}"
    targets: []
    target_types: []
    umi_configurations: {{}}
""")
    r1p, r2p = tmp_path / "r1.fastq.gz", tmp_path / "r2.fastq.gz"
    with gzip.open(r1p, "wt") as f1, gzip.open(r2p, "wt") as f2:
        for i in range(12):
            read = amp
            r1 = read[:70]
            r2 = reverse_complement(read[30:].encode()).decode()
            f1.write(f"@p{i}\n{r1}\n+\n{'I' * len(r1)}\n")
            f2.write(f"@p{i}\n{r2}\n+\n{'I' * len(r2)}\n")

    layout = SequenceLayout.from_yaml(str(layout_path))
    rm = ReferenceManager.from_layout(layout)
    ref_bam = str(tmp_path / "ref.bam")
    align_reads(layout, rm, ref_bam, read1=str(r1p), read2=str(r2p),
                batch_size=8)
    out = str(tmp_path / "dist.bam")
    align_distributed(layout, rm, out, str(tmp_path / "wk"),
                      read1=str(r1p), read2=str(r2p),
                      process_id=0, num_processes=1, batch_size=8)
    got, want = record_multiset(out), record_multiset(ref_bam)
    assert got == want and len(got) == 12


def test_distributed_chain_two_processes(tmp_path):
    layout, layout_path, aligned = build_dataset(tmp_path)

    fq = str(tmp_path / "reads.fastq.gz")
    work = tmp_path / "work_align"
    cwork = tmp_path / "work_collapse"
    work.mkdir()
    cwork.mkdir()
    out_bam = str(tmp_path / "dist_align2.bam")
    cout_bam = str(tmp_path / "dist_collapsed2.bam")
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    # small stripe chunks so 30 reads actually split across ranks
    env["CLIQUE_TPU_SHARD_CHUNK"] = "8"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), layout_path, fq, str(work),
             out_bam, str(cwork), cout_bam, str(p), "2", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for p in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out.decode(errors="replace")

    # both ranks produced part BAMs with records (stripe really split)
    for p in range(2):
        with BamReader(str(work / f"part.p{p}.bam")) as reader:
            assert sum(1 for _ in reader) > 0
    assert record_multiset(out_bam) == record_multiset(aligned)
    # collapse parity is judged on the SAME input BAM: group-member order
    # (consensus read name, ar tag order) follows input order in the
    # reference too, and the merged distributed BAM interleaves stripes
    ref_collapsed = tmp_path / "ref_collapsed.bam"
    collapse(str(ref_collapsed), layout, out_bam)
    assert record_multiset(cout_bam) == record_multiset(str(ref_collapsed))
