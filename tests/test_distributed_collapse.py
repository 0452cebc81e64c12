"""Multi-host collapse: N jax.distributed processes over a shared work
dir must produce the SAME output record multiset as single-host
collapse() (SURVEY 2.11 P4/P5; the shardio boundary of collapse.rs:468-469
realized as psum-histogram ownership + shard exchange)."""

import gzip
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from clique_tpu.align.pipeline import align_reads
from clique_tpu.collapse.pipeline import collapse
from clique_tpu.config.layout import SequenceLayout
from clique_tpu.io.sam import BamReader
from clique_tpu.reference.manager import ReferenceManager

RNG = np.random.default_rng(4242)
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

A5 = "TTCAGACGTGTGCTCTTCCGATCT"
A3 = "AGATCGGAAGAGCACACGTCTGAA"
TARGET = "GGCACTGCGGCTGGAGGTGG"


# worker processes import clique_tpu from the repo root (not installed)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rand_seq(n):
    return RNG.choice(BASES, size=n).tobytes().decode()


def build_dataset(tmp_path):
    """3 cells x 2 umis x 5 reads with one erroneous UMI copy per group."""
    layout_path = tmp_path / "layout.yaml"
    layout_path.write_text(f"""
known_strand: true
reads:
  - !Read1
    orientation: Forward
references:
  amp1:
    sequence: "{A5}{'0' * 16}{'1' * 12}{TARGET}{A3}"
    targets: ["{TARGET}"]
    target_types: ["Cas9WT"]
    umi_configurations:
      cell_id:
        symbol: '0'
        sort_type: "DegenerateTag"
        length: 16
        order: 0
        max_distance: 2
      cell_umi:
        symbol: '1'
        sort_type: "DegenerateTag"
        length: 12
        order: 1
        max_distance: 2
""")
    cells = [rand_seq(16) for _ in range(3)]
    umis = [rand_seq(12) for _ in range(2)]
    fq = tmp_path / "reads.fastq.gz"
    idx = 0
    with gzip.open(fq, "wt") as fh:
        for cell in cells:
            for umi in umis:
                for k in range(5):
                    u = umi
                    if k == 4:
                        u = ("A" if umi[0] != "A" else "C") + umi[1:]
                    read = A5 + cell + u + TARGET + A3
                    fh.write(f"@r{idx}\n{read}\n+\n{'I' * len(read)}\n")
                    idx += 1

    layout = SequenceLayout.from_yaml(str(layout_path))
    rm = ReferenceManager.from_layout(layout)
    aligned = tmp_path / "aligned.bam"
    align_reads(layout, rm, str(aligned), read1=str(fq), batch_size=8)
    return layout, str(layout_path), str(aligned)


def record_multiset(bam_path):
    with BamReader(bam_path) as reader:
        return sorted(
            (r.name, r.reference_name, r.seq,
             tuple(sorted(r.tags.items())))
            for r in reader)


def test_distributed_collapse_single_process(tmp_path):
    from clique_tpu.parallel.distributed import collapse_distributed

    layout, _lp, aligned = build_dataset(tmp_path)
    ref_bam = tmp_path / "ref.bam"
    collapse(str(ref_bam), layout, aligned)

    work = tmp_path / "work1"
    work.mkdir()
    out_bam = tmp_path / "dist1.bam"
    collapse_distributed(str(out_bam), layout, aligned, str(work),
                         process_id=0, num_processes=1)
    assert record_multiset(str(out_bam)) == record_multiset(str(ref_bam))


_WORKER = textwrap.dedent("""
    import sys
    layout_path, aligned, work, out_bam, pid, nproc, port = sys.argv[1:8]
    from clique_tpu.config.layout import SequenceLayout
    from clique_tpu.parallel.distributed import collapse_distributed
    layout = SequenceLayout.from_yaml(layout_path)
    collapse_distributed(out_bam, layout, aligned, work,
                         process_id=int(pid), num_processes=int(nproc),
                         coordinator_address=f"localhost:{port}")
""")


def test_distributed_collapse_two_processes(tmp_path):
    layout, layout_path, aligned = build_dataset(tmp_path)
    ref_bam = tmp_path / "ref.bam"
    collapse(str(ref_bam), layout, aligned)

    work = tmp_path / "work2"
    work.mkdir()
    out_bam = tmp_path / "dist2.bam"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), layout_path, aligned, str(work),
             str(out_bam), str(p), "2", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for p in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out.decode(errors="replace")

    assert record_multiset(str(out_bam)) == record_multiset(str(ref_bam))
