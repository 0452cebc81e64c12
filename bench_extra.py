#!/usr/bin/env python
"""Secondary benchmarks (BASELINE configs 2 and 4 + WFA kernel rates).

Writes BENCH_SECONDARY.json next to this file:
- hifi_align_reads_per_s / hifi_chain_reads_per_s: config 2 - PacBio-HiFi
  low-error preset through the WFA engine (`--engine wfa`), align alone
  and the full align+collapse chain; a CIGAR sample is verified against
  the WFA penalty invariant. hifi_align_dp_reads_per_s is the same
  config through the exact DP; the recorded winner justifies the
  `--mode hifi` default engine.
- convex_align_reads_per_s: the dual-affine (`--engine convex`) engine on
  a structural-variant config (30-80bp cassette dropouts), with the
  fraction of dropouts kept as a single D run and a dual-affine penalty
  invariant check.
- decoy_align_reads_per_s: config 4 - amplicon panel + background decoy
  references (hg38-fragment stand-ins); reads route via kmer vote +
  exhaustive search; decoy reads must land on decoy references.
- wfa_cells_per_s / wfa_tb_cells_per_s: the B=256 x L=512 5%-divergence
  wavefront microbench (score-only and with-traceback), reported as
  DP-equivalent n*m cells/s (comparable to the 3-plane DP fill rate).
- panel_align_reads_per_s: config 5 - multi-amplicon panel read routing
  over the mounted 180-guide library fixture (shared backbone, unique
  ~20bp guides), with routing accuracy.

One JAX process per card: run this after bench.py, never concurrently.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


SCALE = float(os.environ.get("CLIQUE_BENCH_EXTRA_SCALE", "1"))


def log(msg):
    print(f"[bench_extra] {msg}", file=sys.stderr, flush=True)


A5 = "TTCAGACGTGTGCTCTTCCGATCT"
A3 = "AGATCGGAAGAGCACACGTCTGAA"


def _amplicon(rng, bases, n_targets=10):
    targets = [rng.choice(bases, 20).tobytes().decode() + "TGG"
               for _ in range(n_targets)]
    return f"{A5}{'0' * 16}{'1' * 12}{'GAAA'.join(targets)}{A3}", targets


def _write_layout(path, refs):
    with open(path, "w") as fh:
        fh.write("known_strand: true\nreads:\n  - !Read1\n"
                 "    orientation: Forward\nreferences:\n")
        for name, seq, with_umis in refs:
            fh.write(f"  {name}:\n    sequence: \"{seq}\"\n")
            if with_umis:
                fh.write(
                    "    umi_configurations:\n"
                    "      cell_id: {symbol: '0', sort_type: "
                    "\"DegenerateTag\", length: 16, order: 0, "
                    "max_distance: 2}\n"
                    "      cell_umi: {symbol: '1', sort_type: "
                    "\"DegenerateTag\", length: 12, order: 1, "
                    "max_distance: 2}\n")


def _make_reads(path, rng, bases, template: str, n_reads: int, sub_p: float,
                start_idx: int = 0, mode: str = "w"):
    base = np.frombuffer(template.encode(), dtype=np.uint8)
    L = len(base)
    wild = (base < 58) | (base == ord("N"))
    with open(path, mode) as fh:
        for i in range(n_reads):
            read = base.copy()
            read[wild] = rng.choice(bases, int(wild.sum()))
            subs = rng.random(L) < sub_p
            read[subs] = rng.choice(bases, int(subs.sum()))
            fh.write(f"@e{start_idx + i}\n{read.tobytes().decode()}\n+\n"
                     f"{'I' * L}\n")


import numpy as np  # noqa: E402  (after docstring helpers for clarity)


def _align_bench(refs, write_reads, classify=None, post=None, **align_kw):
    """Shared scaffolding for the align benches: temp layout + reads,
    512-record warm run, timed align, optional per-record classification
    over the output BAM, optional `post(out_bam, layout, tmp)` stage run
    inside the temp context (e.g. collapse). Returns (stats, dt,
    classify_result, metrics, post_result)."""
    from clique_tpu.align.pipeline import align_reads
    from clique_tpu.config.layout import SequenceLayout
    from clique_tpu.io.sam import BamReader
    from clique_tpu.reference.manager import ReferenceManager

    with tempfile.TemporaryDirectory() as tmp:
        layout_path = os.path.join(tmp, "layout.yaml")
        _write_layout(layout_path, refs)
        fq = os.path.join(tmp, "reads.fastq")
        write_reads(fq)
        layout = SequenceLayout.from_yaml(layout_path)
        rm = ReferenceManager.from_layout(layout)
        warm = os.path.join(tmp, "warm.fastq")
        with open(fq) as src:
            lines = src.readlines()
        # warm on BOTH ends of the dataset at FULL batch width (512 reads
        # per end): configs that append a second read class (e.g. decoy
        # reads) must compile that class's shapes, and each class must
        # warm the same padded lane count the timed run uses — a narrower
        # warm batch compiles a different (B, n1, n2) variant and leaves
        # the real one to the timed region
        with open(warm, "w") as dst:
            if len(lines) <= 4 * 1024:
                dst.writelines(lines)
            else:
                dst.writelines(lines[:4 * 512])
                dst.writelines(lines[-4 * 512:])
        align_reads(layout, rm, os.path.join(tmp, "w.bam"), read1=warm,
                    batch_size=512, **align_kw)
        metrics = os.path.join(tmp, "m.json")
        out_bam = os.path.join(tmp, "o.bam")
        t0 = time.time()
        stats = align_reads(layout, rm, out_bam, read1=fq, batch_size=512,
                            metrics_path=metrics, **align_kw)
        dt = time.time() - t0
        cls = None
        if classify is not None:
            with BamReader(out_bam, parse_tags=False) as reader:
                cls = classify(reader)
        post_result = None
        if post is not None:
            post_result = post(out_bam, layout, tmp)
        with open(metrics) as fh:
            m = json.load(fh)
    return stats, dt, cls, m, post_result


def _check_cigar_penalties(out_bam, ref_by_name, *, model="affine",
                           x=4, o=6, e=2, o2=24, e2=1, sample=64):
    """In-bench honesty check (VERDICT r2 item 7): a sample of the WFA/
    convex engine's written CIGARs must satisfy the engine's penalty
    invariant — cigar_penalty(cigar, ref, read) == -as tag."""
    from clique_tpu.align.wavefront import cigar_penalty, cigar_penalty_2p
    from clique_tpu.io.sam import BamReader

    checked = 0
    with BamReader(out_bam) as reader:
        for rec in reader:
            ref = ref_by_name[rec.reference_name]
            if model == "affine2p":
                pen = cigar_penalty_2p(rec.cigar, ref, rec.seq, x=x, o1=o,
                                       e1=e, o2=o2, e2=e2, wildcards=True)
            else:
                pen = cigar_penalty(rec.cigar, ref, rec.seq, x=x, o=o, e=e,
                                    wildcards=True)
            got = -float(rec.tags["as"])
            assert pen == got, (rec.name, pen, got)
            checked += 1
            if checked >= sample:
                break
    return checked


def bench_hifi(results):
    """Config 2: HiFi low-error reads through the WFA engine — BOTH
    halves: align reads/s AND the full align+collapse chain (the config
    is "HiFi alignment + collapse", VERDICT r2 missing-6). Reads carry a
    structured cell/UMI population (200 cells x 40 reads) so collapse
    exercises real group clustering, and a sample of written CIGARs is
    checked against the WFA penalty invariant."""
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref_seq, _targets = _amplicon(rng, bases)
    n_cells = max(4, int(200 * SCALE))
    per_cell = 40
    n_reads = n_cells * per_cell
    cells = rng.choice(bases, (n_cells, 16))
    umis = rng.choice(bases, (n_cells, 4, 12))
    base = np.frombuffer(ref_seq.replace("0", "N").replace("1", "N")
                         .encode(), dtype=np.uint8)
    L = len(base)

    def write_reads(fq):
        with open(fq, "w") as fh:
            for i in range(n_reads):
                c = i % n_cells
                read = base.copy()
                read[24:40] = cells[c]
                read[40:52] = umis[c, (i // n_cells) % 4]
                subs = rng.random(L) < 0.005
                read[subs] = rng.choice(bases, int(subs.sum()))
                fh.write(f"@e{i}\n{read.tobytes().decode()}\n+\n"
                         f"{'I' * L}\n")

    def post(out_bam, layout, tmp):
        from clique_tpu.collapse.pipeline import collapse

        checked = _check_cigar_penalties(
            out_bam, {"amplicon1": ref_seq.encode()})
        t0 = time.time()
        n_workers = max(1, (os.cpu_count() or 2) - 1)
        collapse(os.path.join(tmp, "c.bam"), layout, out_bam,
                 n_workers=n_workers)
        return time.time() - t0, checked

    stats, dt, _cls, m, (collapse_dt, checked) = _align_bench(
        [("amplicon1", ref_seq, True)], write_reads, post=post,
        mode="hifi", engine="wfa")
    assert m["engine"] == "wfa"
    results["hifi_align_reads_per_s"] = round(stats.aligned / dt, 1)
    results["hifi_chain_reads_per_s"] = round(
        stats.aligned / (dt + collapse_dt), 1)
    results["hifi_wfa_dp_fallbacks"] = m["wfa_dp_fallbacks"]
    results["hifi_cigar_invariant_checked"] = checked
    # where the wfa chain's wall actually goes (VERDICT r4 item 4): the
    # align/collapse split plus the engine's own phase breakdown
    results["hifi_wfa_chain_phase_seconds"] = {
        "align_s": round(dt, 2), "collapse_s": round(collapse_dt, 2),
        "engine_phases": m.get("wfa_phase_seconds"),
    }
    log(f"hifi: {stats.aligned} reads in {dt:.1f}s align + "
        f"{collapse_dt:.1f}s collapse -> "
        f"{results['hifi_align_reads_per_s']} align reads/s, "
        f"{results['hifi_chain_reads_per_s']} chain reads/s "
        f"({m['wfa_dp_fallbacks']} DP fallbacks, {checked} CIGARs checked)")

    # dp-vs-wfa A/B on the SAME config (VERDICT r3 item 2c): the recorded
    # pair justifies (or dethrones) WFA as the HiFi default engine.
    # The dp leg ALSO runs the collapse half back-to-back so config 2's
    # chain number exists on the DEFAULT engine (VERDICT r4 item 4 — the
    # wfa-only chain capture understated the product ~3-4x).
    def post_dp(out_bam, layout, tmp):
        from clique_tpu.collapse.pipeline import collapse

        t0 = time.time()
        n_workers = max(1, (os.cpu_count() or 2) - 1)
        collapse(os.path.join(tmp, "c.bam"), layout, out_bam,
                 n_workers=n_workers)
        return time.time() - t0

    stats_dp, dt_dp, _c, m_dp, collapse_dt_dp = _align_bench(
        [("amplicon1", ref_seq, True)], write_reads, post=post_dp,
        mode="hifi", engine="dp")
    assert m_dp["engine"] == "dp"
    results["hifi_align_dp_reads_per_s"] = round(stats_dp.aligned / dt_dp, 1)
    results["hifi_chain_dp_reads_per_s"] = round(
        stats_dp.aligned / (dt_dp + collapse_dt_dp), 1)
    results["hifi_default_engine_winner"] = (
        "wfa" if results["hifi_align_reads_per_s"]
        >= results["hifi_align_dp_reads_per_s"] else "dp")
    log(f"hifi A/B: wfa {results['hifi_align_reads_per_s']} vs dp "
        f"{results['hifi_align_dp_reads_per_s']} align reads/s; chain "
        f"wfa {results['hifi_chain_reads_per_s']} vs dp "
        f"{results['hifi_chain_dp_reads_per_s']} -> winner "
        f"{results['hifi_default_engine_winner']}")


def bench_convex(results):
    """The convex (dual-affine) engine on a structural-variant config:
    HiFi-quality reads where half carry a 30-80bp cassette dropout — the
    workload the second gap slope exists for. Written CIGARs are checked
    against the dual-affine penalty invariant; the dropout reads must
    keep their deletion as a single D run."""
    rng = np.random.default_rng(23)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref_seq, _targets = _amplicon(rng, bases)
    n_reads = int(6000 * SCALE)
    base = np.frombuffer(ref_seq.replace("0", "N").replace("1", "N")
                         .encode(), dtype=np.uint8)
    L = len(base)
    body_lo = 64                      # keep anchors + tag zones intact
    body_hi = L - 40

    def write_reads(fq):
        wild = (base < 58) | (base == ord("N"))
        with open(fq, "w") as fh:
            for i in range(n_reads):
                read = base.copy()
                read[wild] = rng.choice(bases, int(wild.sum()))
                subs = rng.random(L) < 0.005
                read[subs] = rng.choice(bases, int(subs.sum()))
                if i % 2:
                    dlen = int(rng.integers(30, 81))
                    start = int(rng.integers(body_lo, body_hi - dlen))
                    read = np.concatenate([read[:start],
                                           read[start + dlen:]])
                fh.write(f"@e{i}\n{read.tobytes().decode()}\n+\n"
                         f"{'I' * len(read)}\n")

    def classify(reader):
        single_run = 0
        sv = 0
        for rec in reader:
            if int(rec.name[1:]) % 2 == 0:
                continue
            sv += 1
            dels = [n for n, op in rec.cigar if op == "D" and n >= 30]
            single_run += len(dels) == 1
        return single_run, sv

    def post(out_bam, _layout, _tmp):
        return _check_cigar_penalties(
            out_bam, {"amplicon1": ref_seq.encode()}, model="affine2p")

    stats, dt, (single_run, sv), m, checked = _align_bench(
        [("amplicon1", ref_seq, True)], write_reads, classify=classify,
        post=post, engine="convex")
    assert m["engine"] == "convex"
    results["convex_align_reads_per_s"] = round(stats.aligned / dt, 1)
    results["convex_sv_single_run_frac"] = round(
        single_run / max(sv, 1), 4)
    results["convex_cigar_invariant_checked"] = checked
    # recorded phase breakdown (VERDICT r3 item 6): where convex wall
    # actually goes — kernel dispatch vs blocking score/window pulls vs
    # host backtrace+replay
    results["convex_phase_seconds"] = m.get("wfa_phase_seconds")
    log(f"convex: {stats.aligned} reads in {dt:.1f}s -> "
        f"{results['convex_align_reads_per_s']} reads/s, "
        f"{single_run}/{sv} dropouts as one D run, "
        f"{checked} CIGARs checked; phases {m.get('wfa_phase_seconds')}; "
        f"engine {m.get('device_seconds')}s, "
        f"host-post {m.get('host_post_seconds')}s")


def bench_decoy(results):
    """Config 4: background decoy subtraction = decoys as extra panel
    references; reads from decoys must route away from the amplicon."""
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref_seq, _targets = _amplicon(rng, bases)
    n_decoys = 8
    decoys = [rng.choice(bases, len(ref_seq)).tobytes().decode()
              for _ in range(n_decoys)]
    n_amp, n_per_decoy = int(6000 * SCALE), max(4, int(250 * SCALE))
    refs = [("amplicon1", ref_seq, True)] + [
        (f"decoy{d}", decoys[d], False) for d in range(n_decoys)]

    def write_reads(fq):
        _make_reads(fq, rng, bases, ref_seq.replace("0", "N")
                    .replace("1", "N"), n_amp, 0.05)
        for d in range(n_decoys):
            _make_reads(fq, rng, bases, decoys[d], n_per_decoy, 0.05,
                        start_idx=100000 + d * n_per_decoy, mode="a")

    def classify(reader):
        correct = 0
        for rec in reader:
            if int(rec.name[1:]) >= 100000:
                correct += rec.reference_name.startswith("decoy")
            else:
                correct += rec.reference_name == "amplicon1"
        return correct

    stats, dt, correct, _m, _p = _align_bench(refs, write_reads, classify)
    total = n_amp + n_decoys * n_per_decoy
    results["decoy_align_reads_per_s"] = round(stats.aligned / dt, 1)
    results["decoy_routing_accuracy"] = round(correct / stats.aligned, 4)
    log(f"decoy: {stats.aligned}/{total} reads in {dt:.1f}s -> "
        f"{results['decoy_align_reads_per_s']} reads/s, routing acc "
        f"{results['decoy_routing_accuracy']}")


def bench_panel(results):
    """Config 5: multi-amplicon panel with read routing — the mounted
    180-guide CRISPR library (rust_cmd/test_data/18guide1_pcr_sequence
    .fasta), whose references share a backbone and differ only in the
    ~20bp guide, so routing rests on the unique-kmer vote exactly as in
    quick_alignment_search (alignment_functions.rs:693-767)."""
    from clique_tpu.io.fastq import read_fasta

    fasta = ("/root/reference/rust_cmd/test_data/"
             "18guide1_pcr_sequence.fasta")
    if not os.path.exists(fasta):
        log("panel: fixture fasta missing; skipped")
        return
    refs = read_fasta(fasta)
    rng = np.random.default_rng(13)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    per_ref = max(2, int(40 * SCALE))

    def write_reads(fq):
        mode = "w"
        for ri, (_name, seq) in enumerate(refs):
            _make_reads(fq, rng, bases, seq.decode(), per_ref, 0.05,
                        start_idx=ri * per_ref, mode=mode)
            mode = "a"

    def classify(reader):
        return sum(rec.reference_name ==
                   refs[int(rec.name[1:]) // per_ref][0]
                   for rec in reader)

    def post(out_bam, _layout, _tmp):
        # Router parity A/B (VERDICT r4 weak-7): per-read agreement
        # between the production route (kmer vote > 0.90 else exhaustive,
        # quick_alignment_search semantics) and OUR OWN exhaustive
        # max-score search (= the reference's fallback semantics,
        # alignment_functions.rs:769-827, last-max tie order). Sampled:
        # every truth-misrouted read + an even slice of the rest. This
        # says whether the ~0.2% truth-misses are router divergence or
        # reads the exhaustive search itself misroutes (benign parity).
        from clique_tpu.align.pipeline import BatchAligner
        from clique_tpu.align.scoring import AffineScoring
        from clique_tpu.io.sam import BamReader

        routes = {}
        seqs = {}
        with BamReader(out_bam, parse_tags=False) as reader:
            for rec in reader:
                routes[rec.name] = rec.reference_name
                seqs[rec.name] = rec.seq
        names = sorted(routes, key=lambda n: int(n[1:]))
        truth = {n: refs[int(n[1:]) // per_ref][0] for n in names}
        mis = [n for n in names if routes[n] != truth[n]]
        step = max(1, len(names) // 192)
        sample = list(dict.fromkeys(mis + names[::step]))
        aligner = BatchAligner(AffineScoring.aligner_default(),
                               batch_size=512)
        ref_seqs = [s for _n, s in refs]
        ref_names = [n for n, _s in refs]
        pair_refs, pair_reads = [], []
        for n in sample:
            pair_refs.extend(ref_seqs)
            pair_reads.extend([seqs[n]] * len(refs))
        outs = aligner.align_pairs(pair_refs, pair_reads)
        mis_set = set(mis)
        unbiased = [n for n in names[::step] if n not in mis_set]
        agree = 0
        agree_unbiased = 0
        mis_shared = 0
        disagreements = []
        for si, n in enumerate(sample):
            base = si * len(refs)
            best = 0
            for i in range(len(refs)):
                if outs[base + i][3] >= outs[base + best][3]:
                    best = i   # last max (Rust max_by tie order)
            exh = ref_names[best]
            if exh == routes[n]:
                agree += 1
                if n not in mis_set:
                    agree_unbiased += 1
            else:
                disagreements.append(n)
            if n in mis_set and exh != truth[n]:
                mis_shared += 1
        return (len(sample), agree, len(mis), mis_shared, disagreements,
                len(unbiased), agree_unbiased)

    stats, dt, correct, _m, parity = _align_bench(
        [(n, s.decode(), False) for n, s in refs], write_reads, classify,
        post=post)
    total = per_ref * len(refs)
    results["panel_align_reads_per_s"] = round(stats.aligned / dt, 1)
    results["panel_routing_accuracy"] = round(
        correct / max(stats.aligned, 1), 4)
    (n_sample, agree, n_mis, mis_shared, disagreements, n_unb,
     agree_unb) = parity
    # sampled agreement is misroute-ENRICHED (every truth-miss is in the
    # sample); the unbiased slice estimates population-wide agreement
    results["panel_router_agreement"] = round(
        agree_unb / max(n_unb, 1), 4)
    results["panel_router_agreement_misroute_enriched"] = round(
        agree / max(n_sample, 1), 4)
    results["panel_router_sample"] = n_sample
    results["panel_truth_misroutes"] = n_mis
    results["panel_misroutes_shared_with_exhaustive"] = mis_shared
    results["panel_quick_vote_divergences"] = len(disagreements)
    log(f"panel: {stats.aligned}/{total} reads over {len(refs)} refs in "
        f"{dt:.1f}s -> {results['panel_align_reads_per_s']} reads/s, "
        f"routing acc {results['panel_routing_accuracy']}; router vs "
        f"exhaustive: unbiased agreement {agree_unb}/{n_unb}, enriched "
        f"{agree}/{n_sample} (truth-misroutes {n_mis}, "
        f"shared-with-exhaustive {mis_shared}; "
        f"disagreeing reads {disagreements[:8]})")


def bench_wfa(results):
    """WFA kernel rates at L=512, 5% divergence — PIPELINED: W independent
    dispatches go out before any result is pulled, so the measurement is
    compute-bound instead of fetch-latency-bound (one dispatch of B=256
    measures per-dispatch latency, not the kernel). The single-dispatch
    number is kept alongside so the latency share stays visible."""
    from clique_tpu.align.wavefront import (
        wfa_affine_batch,
        wfa_affine_tb_batch,
    )

    rng = np.random.default_rng(3)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    L = 512
    smax = 192  # ~5% x 512 x penalty 4 = 102 expected; headroom 2x

    def make(B):
        refs = rng.choice(bases, (B, L)).astype(np.uint8)
        reads = refs.copy()
        subs = rng.random((B, L)) < 0.05
        reads[subs] = rng.choice(bases, int(subs.sum()))
        lens = np.full(B, L, dtype=np.int32)
        return refs, reads, lens

    # (kernel, in-flight dispatches, lanes per dispatch): run-table HBM
    # bounds B; the tb kernel adds the [smax+1, B, K] op store
    cfgs = (("wfa", wfa_affine_batch, 8, 1024 if SCALE >= 1 else 32),
            ("wfa_tb", wfa_affine_tb_batch, 6, 512 if SCALE >= 1 else 32))
    for name, fn, W, B in cfgs:
        data = [make(B) for _ in range(W)]

        def run(d):
            refs, reads, lens = d
            out = fn(refs, reads, lens, lens, n1=L, n2=L, smax=smax)
            return out[0] if isinstance(out, tuple) else out

        np.asarray(run(data[0]))       # compile + warm
        t0 = time.time()
        scores0 = np.asarray(run(data[0]))
        dt1 = time.time() - t0
        results[f"{name}_single_dispatch_cells_per_s"] = \
            round(B * L * L / dt1)
        t0 = time.time()
        pend = [run(d) for d in data]  # all dispatches in flight
        censored = 0
        for p in pend:
            censored += int((np.asarray(p) > smax).sum())
        dt = time.time() - t0
        cells = W * B * L * L
        results[f"{name}_cells_per_s"] = round(cells / dt)
        log(f"{name}: {W} x B={B} L={L} in {dt * 1e3:.0f}ms -> "
            f"{cells / dt / 1e9:.1f} G dp-equiv cells/s pipelined "
            f"({B * L * L / dt1 / 1e9:.1f} G single-dispatch, "
            f"{censored} censored)")


def main():
    from clique_tpu.utils.jaxcfg import enable_persistent_cache

    enable_persistent_cache()
    all_benches = (bench_wfa, bench_hifi, bench_convex, bench_decoy,
                   bench_panel)
    picked = sys.argv[1:]
    benches = [fn for fn in all_benches
               if not picked or fn.__name__.removeprefix("bench_") in picked]
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "BENCH_SECONDARY.json")
    results = {}
    if os.path.exists(out):
        # start from the existing JSON so a full run refreshes every
        # bench's keys but keeps hand-maintained provenance fields (e.g.
        # "statistic"); a targeted rerun refreshes only the selected keys
        with open(out) as fh:
            results = json.load(fh)
    if not picked:
        results.pop("statistic", None)
        results["statistic"] = "single_warm_run"
    for fn in benches:
        try:
            fn(results)
        except Exception as exc:  # keep partial results
            log(f"{fn.__name__} FAILED: {exc!r}")
            results[fn.__name__ + "_error"] = repr(exc)
    with open(out, "w") as fh:
        json.dump(results, fh, indent=2)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
