#!/usr/bin/env python
"""Smoke test: the align -> collapse -> call chain on NVIDIA GPUs.

    python chip_smoke.py               # one GPU: phases 0-3
    python chip_smoke.py --four-cards  # four GPUs: phases (a)-(c) only

One GPU:
  0. the device, the native BAM/FASTQ library and the compile cache;
  1. the CUDA DP fill against the XLA scan, bit for bit, at bench width
     (B=1024, n1=n2=384) and on ragged batches with N bytes in every
     special mode; the int8 one-hot Hamming product against NumPy at
     4,096 tags x 65,536 allowlist entries of 16 bp;
  2. every pinned golden output recomputed on the card and byte-compared
     with tests/data/golden*/, and the opt-in paths without a pin
     (--router hmm, --bandwidth 32, the local fill) run once;
  3. the bench deployment (342 bp amplicon, 500 cells x 4 UMIs, 80,000
     reads, batch 1024) through `clique-tpu run` and the separate verbs,
     with 256 sampled alignments checked against the host model
     align/cpu.py.

Four GPUs (--four-cards), each phase in its own child process, one at a
time; this process never opens a card:
  a. __graft_entry__.dryrun_multichip(4): the golden chain on a 4-card
     mesh byte-matches the pins;
  b. the phase-3 chain on a 4-card batch mesh against the same chain
     with use_mesh=False on card 0;
  c. `clique-tpu align` / `collapse --distributed-world 4` as four
     processes, one card each, against the pins.

Any failure exits non-zero. The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "golden")
GOLDEN_PE = os.path.join(ROOT, "tests", "data", "golden_pe")
GOLDEN_ML = os.path.join(ROOT, "tests", "data", "golden_ml")
BENCH_READS = 80000
BENCH_BATCH = 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")
    log(f"  ok: {what}")


def _load_tool(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _payload(path: str) -> bytes:
    """Decompressed BAM bytes, independent of BGZF block framing."""
    from clique_tpu.io.sam import read_voffset_range

    return read_voffset_range(path, 0)


def _records(path: str) -> list:
    """Sorted record multiset of a BAM (order-free comparison)."""
    from clique_tpu.io.sam import BamReader

    with BamReader(path) as reader:
        return sorted((r.name, r.reference_name, r.pos,
                       tuple(r.cigar), r.seq, tuple(sorted(r.tags.items())))
                      for r in reader)


def _same_file(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _peak_bytes():
    """Largest peak_bytes_in_use over the local devices (None where the
    backend keeps no memory statistics)."""
    import jax

    stats = [d.memory_stats() for d in jax.local_devices()]
    if not all(stats):
        return None
    return max(s["peak_bytes_in_use"] for s in stats)


# --- phase 0 -----------------------------------------------------------------

def phase0_device() -> dict:
    from clique_tpu.native import get_lib
    from clique_tpu.utils.jaxcfg import device_report, enable_persistent_cache

    log("phase 0: device")
    cache = enable_persistent_cache()
    rep = device_report()
    log(f"  jax {rep['jax']}: {rep['count']} x {rep['kind']} "
        f"(platform {rep['platform']})")
    check(rep["platform"] == "gpu", "JAX runs on a GPU")
    log(f"  nvidia-smi name, power.limit: {rep['gpu']}")
    log("  native BAM/FASTQ library: "
        + ("built" if get_lib() is not None else
           "NOT built (pure-Python codecs)"))
    log(f"  compile cache: {cache}")
    return rep


# --- phase 1 -----------------------------------------------------------------

def _fill_case(rng, B, n1, n2, *, ragged, shared_ref, n_rate):
    """A batch of refs/reads: reads are references with 5% substitutions
    and a few indels; N bytes at n_rate on both sides."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    R = 1 if shared_ref else B
    refs = np.zeros((R, n1 - 1), np.uint8)
    reads = np.zeros((B, n2 - 1), np.uint8)
    ref_lens = np.zeros(B, np.int32)
    read_lens = np.zeros(B, np.int32)
    for r in range(R):
        lr = int(rng.integers(n1 // 3, n1)) if ragged else n1 - 1
        refs[r, :lr] = rng.choice(bases, lr)
        refs[r, :lr][rng.random(lr) < n_rate] = ord("N")
        ref_lens[slice(None) if shared_ref else r] = lr
    for b in range(B):
        src = refs[0 if R == 1 else b, :ref_lens[b]].copy()
        src[src == ord("N")] = ord("A")
        subs = rng.random(len(src)) < 0.05
        src[subs] = rng.choice(bases, int(subs.sum()))
        if ragged:
            cut = int(rng.integers(0, 8))
            ins = rng.choice(bases, int(rng.integers(0, 8)))
            at = int(rng.integers(0, len(src)))
            src = np.concatenate([src[:at], ins, src[at + cut:]])
        src = src[:n2 - 1]
        src[rng.random(len(src)) < n_rate] = ord("N")
        reads[b, :len(src)] = src
        read_lens[b] = len(src)
    return refs, reads, ref_lens, read_lens


def phase1_kernels() -> None:
    import functools

    import jax
    import numpy as np

    from clique_tpu.align import batch as dbatch
    from clique_tpu.align.cuda_fill import build, cuda_fill
    from clique_tpu.align.pipeline import RUST_BIO_COMPAT
    from clique_tpu.align.scoring import AffineScoring
    from clique_tpu.collapse.distance import _match_count_kernel

    log("phase 1: kernels against their plain references")
    t0 = time.time()
    log(f"  CUDA DP fill library: {build()} "
        f"({time.time() - t0:.1f} s to build or find)")
    rng = np.random.default_rng(7)
    cases = [
        ("bench width, shared reference, ref_n_only", 1024, 384, 384,
         False, True, 0.0, "ref_n_only", RUST_BIO_COMPAT),
        ("ragged with N bytes, both", 256, 384, 384, True, False, 0.03,
         "both", AffineScoring.aligner_default()),
        ("ragged with N bytes, ref_n_only", 256, 256, 384, True, False,
         0.03, "ref_n_only", RUST_BIO_COMPAT),
        ("ragged with N bytes, none", 128, 384, 256, True, False, 0.03,
         "none", AffineScoring.hifi_default()),
    ]
    for name, B, n1, n2, ragged, shared, n_rate, mode, scoring in cases:
        refs, reads, rl, dl = _fill_case(rng, B, n1, n2, ragged=ragged,
                                         shared_ref=shared, n_rate=n_rate)
        params = dbatch.scoring_to_params(scoring)
        kw = dict(n1=n1, n2=n2, special_mode=mode)
        kernel = jax.jit(functools.partial(cuda_fill, **kw))
        w_k, c_k = (np.asarray(a) for a in kernel(refs, reads, rl, dl,
                                                  params))
        w_s, c_s = (np.asarray(a) for a in dbatch.scan_fill(
            refs, reads, rl, dl, params, **kw))
        check(w_k.shape == w_s.shape and np.array_equal(w_k, w_s),
              f"{name}: packed words {w_k.shape} bit-identical "
              f"({int((w_k != w_s).sum())} differ)")
        check(np.array_equal(c_k.view(np.int32), c_s.view(np.int32)),
              f"{name}: corner scores bit-identical")
        bw = np.maximum(np.maximum(rl, dl), 1)
        res = {fill: dbatch.align_batch_device(
            refs, reads, rl, dl, bw, params, fill=fill,
            return_traceback=False, **kw)[0] for fill in ("cuda", "scan")}
        for field in ("ops", "n_ops", "score", "ops_packed", "start_z"):
            a = np.asarray(getattr(res["cuda"], field))
            b = np.asarray(getattr(res["scan"], field))
            check(a.dtype == b.dtype and np.array_equal(
                a.view(np.uint8), b.view(np.uint8)),
                f"{name}: {field} bit-identical")
        if name.startswith("bench"):
            mem = kernel.lower(refs, reads, rl, dl, params).compile() \
                .memory_analysis()
            log(f"  fill memory_analysis at B={B}, n1={n1}, n2={n2}: "
                f"{mem}")

    # int8 one-hot Hamming product (integer accumulate: no TF32 question)
    U, K, L = 4096, 65536, 16
    tags = rng.integers(0, 4, (U, L)).astype(np.int32)
    allow = rng.integers(0, 4, (K, L)).astype(np.int32)
    allow[:U] = tags                       # plant hits at distance 0..2
    for k in range(U):
        allow[k, rng.integers(0, L, int(rng.integers(0, 3)))] = \
            rng.integers(0, 4)
    got = np.asarray(_match_count_kernel(tags, allow, n_classes=4))
    eye = np.eye(4)
    a_oh = eye[allow].reshape(K, L * 4)
    ok = got.shape == (U, K)
    for u0 in range(0, U, 512):
        t_oh = eye[tags[u0:u0 + 512]].reshape(-1, L * 4)
        want = np.rint(t_oh @ a_oh.T).astype(np.uint8)
        ok = ok and np.array_equal(got[u0:u0 + 512], want)
    check(ok, f"int8 Hamming product exact vs NumPy at {U} x {K} x {L} bp "
              f"({int((got == L).sum())} exact hits)")


# --- phase 2 -----------------------------------------------------------------

def phase2_golden() -> None:
    import numpy as np

    from clique_tpu import cli
    from clique_tpu.io.sam import BamReader

    log("phase 2: pinned golden outputs on the card")
    mg = _load_tool("make_golden")
    with tempfile.TemporaryDirectory() as tmp:
        for tag, run, gdir in (("golden", mg.run_pipeline, GOLDEN),
                               ("golden_pe", mg.run_pe_pipeline, GOLDEN_PE),
                               ("golden_ml", mg.run_ml_pipeline, GOLDEN_ML)):
            wd = os.path.join(tmp, tag)
            os.makedirs(wd)
            aligned, collapsed, alleles = run(wd)
            for fresh, pin in ((aligned, "aligned.bam"),
                               (collapsed, "collapsed.bam")):
                check(_payload(fresh) == _payload(os.path.join(gdir, pin)),
                      f"{tag}/{pin} byte-identical to the pin")
            if alleles is not None:
                check(_same_file(alleles, os.path.join(gdir, "alleles.tsv")),
                      f"{tag}/alleles.tsv byte-identical to the pin")
        wd = os.path.join(tmp, "engines")
        os.makedirs(wd)
        for engine in ("wfa", "convex"):
            fresh = mg.run_engine(wd, engine)
            check(_payload(fresh) == _payload(
                os.path.join(GOLDEN, f"aligned_{engine}.bam")),
                f"golden/aligned_{engine}.bam byte-identical to the pin")
        check(_same_file(mg.run_inversion(wd),
                         os.path.join(GOLDEN, "inversion.tsv")),
              "golden/inversion.tsv byte-identical to the pin")

        # opt-in paths with no pin: each must finish on the golden reads
        layout, rm = mg._load_layout(wd)
        reads = os.path.join(GOLDEN, "reads.fastq.gz")
        for extra in (["--router", "hmm"], ["--bandwidth", "32"]):
            out = os.path.join(wd, f"opt{extra[1]}.bam")
            rc = cli.main(["align", "--read-structure",
                           os.path.join(wd, "layout.yaml"), "--read1", reads,
                           "--output-bam-file", out, "--batch-size", "16"]
                          + extra)
            with BamReader(out) as reader:
                n = sum(1 for _ in reader)
            check(rc == 0 and n > 0, f"align {' '.join(extra)} finished "
                                     f"({n} records)")
        from clique_tpu.align import batch as dbatch
        from clique_tpu.align.scoring import AffineScoring
        import gzip

        ref = next(iter(rm.references.values())).sequence
        with gzip.open(reads, "rb") as fh:
            seqs = fh.read().split(b"\n")[1::4][:32]
        refs_a, _ = dbatch.pad_batch([ref] * len(seqs))
        reads_a, dl = dbatch.pad_batch(seqs)
        rl = np.full(len(seqs), len(ref), np.int32)
        loc, _ = dbatch.align_batch_device(
            refs_a, reads_a, rl, dl, np.maximum(rl, dl),
            dbatch.scoring_to_params(AffineScoring.aligner_default()),
            n1=refs_a.shape[1] + 1, n2=reads_a.shape[1] + 1, local=True,
            return_traceback=False)
        score = np.asarray(loc.score)
        check(bool(np.isfinite(score).all() and (score > 0).all()
                   and (np.asarray(loc.n_ops) > 0).all()),
              f"local (Waterman-Eggert) fill finished on {len(seqs)} "
              f"golden reads")


# --- phase 3 -----------------------------------------------------------------

class _RefNOnly:
    """The single-reference scoring rule of the align path (rust-bio
    compatible): only a reference-side N scores as the special match."""

    def __init__(self, scoring):
        self._s = scoring

    def __getattr__(self, name):
        return getattr(self._s, name)

    def match_mismatch(self, a: int, b: int) -> float:
        if a == ord("N"):
            return self._s.special_character_score
        return self._s.match_score if a == b else self._s.mismatch_score


def _host_check(args):
    ref, read = args
    from clique_tpu.align.cpu import affine_align
    from clique_tpu.align.pipeline import RUST_BIO_COMPAT

    res = affine_align(ref, read, _RefNOnly(RUST_BIO_COMPAT))
    return res.cigar_string, res.score


def _run_chain_verbs(data: dict, wd: str, tag: str) -> dict:
    """The chain through `clique-tpu run`, then align/collapse/call as
    separate verbs; returns the output paths and host-clock walls."""
    from clique_tpu import cli

    lay, fq = data["layout"], data["fastq"]
    p = {k: os.path.join(wd, f"{tag}_{k}") for k in
         ("aligned.bam", "collapsed.bam", "alleles.tsv", "a.bam", "c.bam",
          "calls.tsv")}
    t = {}
    t0 = time.time()
    rc = cli.main(["run", "--read-structure", lay, "--read1", fq,
                   "--aligned-bam-file", p["aligned.bam"],
                   "--output-bam-file", p["collapsed.bam"],
                   "--alleles", p["alleles.tsv"],
                   "--batch-size", str(BENCH_BATCH)])
    t["run"] = time.time() - t0
    check(rc == 0, f"{tag}: clique-tpu run exited 0")
    t0 = time.time()
    rc = cli.main(["align", "--read-structure", lay, "--read1", fq,
                   "--output-bam-file", p["a.bam"],
                   "--batch-size", str(BENCH_BATCH)])
    t["align"] = time.time() - t0
    t0 = time.time()
    rc |= cli.main(["collapse", "--read-structure", lay,
                    "--input-bam-file", p["a.bam"],
                    "--output-bam-file", p["c.bam"]])
    t["collapse"] = time.time() - t0
    t0 = time.time()
    rc |= cli.main(["call", "--read-structure", lay,
                    "--input-bam-file", p["c.bam"], "--output",
                    p["calls.tsv"]])
    t["call"] = time.time() - t0
    check(rc == 0, f"{tag}: align, collapse and call exited 0")
    p["walls"] = t
    return p


def phase3_chain(gpu: str) -> None:
    import random

    import bench
    from clique_tpu import cli
    from clique_tpu.align.pipeline import RUST_BIO_COMPAT, BatchAligner
    from clique_tpu.io.sam import BamReader

    log(f"phase 3: bench deployment, {BENCH_READS} reads, batch "
        f"{BENCH_BATCH}, through clique-tpu run")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        data = bench.write_dataset(tmp, BENCH_READS)
        log(f"  dataset written in {time.time() - t0:.1f} s (host clock)")
        warm = dict(data, fastq=os.path.join(tmp, "warm.fastq"))
        with open(data["fastq"]) as src, open(warm["fastq"], "w") as dst:
            for _ in range(4 * 9 * BENCH_BATCH):
                dst.write(src.readline())
        t0 = time.time()
        cli.main(["run", "--read-structure", warm["layout"], "--read1",
                  warm["fastq"], "--aligned-bam-file",
                  os.path.join(tmp, "w.bam"), "--output-bam-file",
                  os.path.join(tmp, "wc.bam"), "--batch-size",
                  str(BENCH_BATCH)])
        log(f"  compile + warm-up run on {9 * BENCH_BATCH} reads: "
            f"{time.time() - t0:.1f} s (host clock)")

        out = _run_chain_verbs(data, tmp, "main")
        walls = out["walls"]
        log(f"  stage walls (host clock, s): run {walls['run']:.2f}; "
            f"separate verbs: align {walls['align']:.2f}, collapse "
            f"{walls['collapse']:.2f}, call {walls['call']:.2f}")
        log(f"  chain reads/s: {BENCH_READS / walls['run']:.1f} "
            f"(clique-tpu run, {BENCH_READS} reads, on {gpu})")
        log(f"  peak device bytes in use: {_peak_bytes()}")
        check(_payload(out["aligned.bam"]) == _payload(out["a.bam"]),
              "run and align verbs write identical aligned BAMs")
        check(_payload(out["collapsed.bam"]) == _payload(out["c.bam"]),
              "run and collapse verbs write identical collapsed BAMs")
        check(_same_file(out["alleles.tsv"], out["calls.tsv"]),
              "run and call verbs write identical allele tables")

        with BamReader(out["aligned.bam"]) as reader:
            recs = [(r.seq, "".join(f"{n}{op}" for n, op in r.cigar))
                    for r in reader]
        check(len(recs) == BENCH_READS, f"{len(recs)} reads aligned")
        with BamReader(out["collapsed.bam"]) as reader:
            n_groups = sum(1 for _ in reader)
        log(f"  consensus groups: {n_groups} (generator: "
            f"{data['n_cells'] * data['n_umis']} (cell, UMI) pairs)")
        check(n_groups > 0, "collapse produced consensus groups")

        ref = data["ref_seq"].encode()
        sample = random.Random(3).sample(recs, 256)
        aligner = BatchAligner(RUST_BIO_COMPAT, BENCH_BATCH,
                               special_mode="ref_n_only")
        dev = aligner.align_pairs([ref] * len(sample),
                                  [s for s, _ in sample])
        import multiprocessing as mp

        env_cpu = {"JAX_PLATFORMS": "cpu"}
        old = {k: os.environ.get(k) for k in env_cpu}
        os.environ.update(env_cpu)        # workers never open the card
        try:
            with mp.get_context("spawn").Pool(8) as pool:
                host = pool.map(_host_check, [(ref, s) for s, _ in sample])
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        bad = [i for i, ((_s, bam_cig), (h_cig, h_score), d) in
               enumerate(zip(sample, host, dev))
               if bam_cig != h_cig or d[3] != h_score
               or "".join(f"{n}{op}" for n, op in d[2]) != h_cig]
        check(not bad, f"256 sampled reads: BAM CIGAR, device CIGAR and "
                       f"score equal the host model ({len(bad)} differ)")


# --- four cards --------------------------------------------------------------

def _child_env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cuda"
    env.update(extra)
    return env


def _run_child(args, env=None) -> str:
    """Run this script as a child; echo and return its standard output."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__)] + args,
                         env=env or _child_env(), stdout=subprocess.PIPE,
                         text=True, timeout=1500)
    sys.stdout.write(res.stdout)
    sys.stdout.flush()
    if res.returncode != 0:
        raise SystemExit(f"chip_smoke FAILED: child {args} exited "
                         f"{res.returncode}")
    return res.stdout


def child_mesh_dryrun() -> None:
    import jax

    import __graft_entry__

    log("phase a: dryrun_multichip(4)")
    check(len(jax.devices()) == 4, "4 devices visible")
    __graft_entry__.dryrun_multichip(4)
    d = jax.devices()[0]
    print(json.dumps({"platform": d.platform, "kind": d.device_kind,
                      "count": len(jax.devices())}))


def child_mesh_chain() -> None:
    import jax

    import bench
    from clique_tpu.chain import run_chain
    from clique_tpu.config.layout import SequenceLayout
    from clique_tpu.reference.manager import ReferenceManager

    log("phase b: bench chain on a 4-card mesh vs one card")
    check(len(jax.devices()) == 4, "4 devices visible")
    with tempfile.TemporaryDirectory() as tmp:
        data = bench.write_dataset(tmp, BENCH_READS)
        layout = SequenceLayout.from_yaml(data["layout"])
        rm = ReferenceManager.from_layout(layout)
        outs = {}
        for use_mesh in (True, False):
            a = os.path.join(tmp, f"a{use_mesh}.bam")
            c = os.path.join(tmp, f"c{use_mesh}.bam")
            al = os.path.join(tmp, f"al{use_mesh}.tsv")
            t0 = time.time()
            run_chain(layout, rm, a, c, read1=data["fastq"],
                      batch_size=BENCH_BATCH, alleles_path=al,
                      use_mesh=use_mesh)
            log(f"  use_mesh={use_mesh}: chain {time.time() - t0:.2f} s "
                f"(host clock, compile included)")
            outs[use_mesh] = (a, c, al)
        (a4, c4, al4), (a1, c1, al1) = outs[True], outs[False]
        check(_payload(a4) == _payload(a1), "4-card aligned BAM == 1-card")
        check(_payload(c4) == _payload(c1),
              "4-card collapsed BAM == 1-card")
        check(_same_file(al4, al1), "4-card allele table == 1-card")


def four_cards_distributed() -> None:
    """Phase c: four rank processes, one card each (CUDA_VISIBLE_DEVICES),
    through the CLI's --distributed-world path."""
    log("phase c: clique-tpu align / collapse --distributed-world 4")
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(GOLDEN, "layout.yaml.in")) as fh:
            text = fh.read().replace(
                "@ALLOWLIST@", os.path.join(GOLDEN, "allowlist.txt"))
        layout = os.path.join(tmp, "layout.yaml")
        with open(layout, "w") as fh:
            fh.write(text)
        reads = os.path.join(GOLDEN, "reads.fastq.gz")
        for verb, io_args, pin, out in (
                ("align", ["--read1", reads, "--batch-size", "16"],
                 "aligned.bam", os.path.join(tmp, "dist_aligned.bam")),
                ("collapse", ["--input-bam-file",
                              os.path.join(GOLDEN, "aligned.bam")],
                 "collapsed.bam", os.path.join(tmp, "dist_collapsed.bam"))):
            work = os.path.join(tmp, f"work_{verb}")
            os.makedirs(work)
            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            procs = []
            for rank in range(4):
                env = _child_env(CUDA_VISIBLE_DEVICES=str(rank),
                                 CLIQUE_TPU_SHARD_CHUNK="8")
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "clique_tpu.cli", verb,
                     "--read-structure", layout, "--output-bam-file", out,
                     "--work-dir", work, "--distributed-world", "4",
                     "--distributed-rank", str(rank),
                     "--distributed-coordinator", f"localhost:{port}"]
                    + io_args, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
            logs = [p.communicate(timeout=900)[0] for p in procs]
            for rank, (p, text) in enumerate(zip(procs, logs)):
                if p.returncode != 0:
                    sys.stdout.write(text[-4000:])
                check(p.returncode == 0, f"{verb} rank {rank} exited 0")
            check(_records(out) == _records(os.path.join(GOLDEN, pin)),
                  f"distributed {verb}: records identical to the pinned "
                  f"{pin}")


def four_cards() -> None:
    from clique_tpu.utils.jaxcfg import gpu_name_and_power_limit

    gpu = gpu_name_and_power_limit()
    log(f"nvidia-smi name, power.limit:\n{gpu}")
    out = _run_child(["--child", "mesh-dryrun"])
    device = json.loads([l for l in out.splitlines()
                         if l.startswith("{")][-1])
    _run_child(["--child", "mesh-chain"])
    four_cards_distributed()
    check(device["count"] == 4 and device["platform"] == "gpu",
          "four GPUs")
    print(json.dumps({"ok": True, "device": device}))


def one_card() -> None:
    rep = phase0_device()
    phase1_kernels()
    phase2_golden()
    phase3_chain(rep["gpu"])
    log(f"nvidia-smi name, power.limit: {rep['gpu']}")
    print(json.dumps({"ok": True, "device": {
        k: rep[k] for k in ("platform", "kind", "count")}}))


def main(argv) -> None:
    if not os.path.isdir(os.path.join(ROOT, "clique_tpu")):
        raise SystemExit("chip_smoke: run it from a checkout of the repo "
                         "(clique_tpu/ not found beside it)")
    # a broken CUDA plugin must be an error, not a silent CPU run
    os.environ["JAX_PLATFORMS"] = "cuda"
    sys.path.insert(0, ROOT)
    if argv[:1] == ["--child"]:
        {"mesh-dryrun": child_mesh_dryrun,
         "mesh-chain": child_mesh_chain}[argv[1]]()
    elif argv == ["--four-cards"]:
        four_cards()
    elif not argv:
        one_card()
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
