#!/usr/bin/env python
"""CUDA DP fill against the XLA scan fill, on one GPU.

    python tools/ab_fill.py            # fill alone, then the chain A/B
    python tools/ab_fill.py --fill     # fill alone only

Fill alone: the fill (cuda_fill vs scan_fill) and the fill plus traceback
walk (align_batch_device) at B=1024, n1=n2=384, each a median of timed
calls ending in block_until_ready.

Chain: the bench deployment (bench.write_dataset, 80,000 reads, batch
1024) through the fused chain (clique_tpu.chain.run_chain), alternating
the fill as scan, kernel, kernel, scan; the fill is chosen through the
BatchAligner's `fill` argument ("scan" or "auto" = the kernel on a GPU).
Each variant is warmed up once first. Prints one JSON line per
measurement, with the card's name and power limit.
"""

import functools
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def time_fill(gpu: str, reps: int = 20) -> None:
    import jax
    import numpy as np

    from clique_tpu.align import batch as dbatch
    from clique_tpu.align.cuda_fill import cuda_fill
    from clique_tpu.align.pipeline import RUST_BIO_COMPAT

    B, n1, n2 = 1024, 384, 384
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = rng.choice(bases, (1, n1 - 1))
    reads = np.repeat(ref, B, axis=0)
    subs = rng.random(reads.shape) < 0.05
    reads[subs] = rng.choice(bases, int(subs.sum()))
    rl = np.full(B, n1 - 1, np.int32)
    dl = np.full(B, n2 - 1, np.int32)
    bw = np.maximum(rl, dl)
    params = dbatch.scoring_to_params(RUST_BIO_COMPAT)
    args = [jax.device_put(a) for a in (ref, reads, rl, dl)]
    bw_d = jax.device_put(bw)
    kw = dict(n1=n1, n2=n2, special_mode="ref_n_only")
    kernel = jax.jit(functools.partial(cuda_fill, **kw))
    calls = {
        "fill_cuda": lambda: kernel(*args, params),
        "fill_scan": lambda: dbatch.scan_fill(*args, params, **kw),
        "fill_walk_cuda": lambda: dbatch.align_batch_device(
            *args, bw_d, params, fill="cuda", return_traceback=False, **kw),
        "fill_walk_scan": lambda: dbatch.align_batch_device(
            *args, bw_d, params, fill="scan", return_traceback=False, **kw),
    }
    out = {}
    for name, call in calls.items():
        jax.block_until_ready(call())            # compile
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(call())
            ts.append(time.perf_counter() - t0)
        out[name] = _median(ts)
    print(json.dumps({"measure": "fill_alone_median_s", "B": B, "n1": n1,
                      "n2": n2, "reps": reps, "gpu": gpu, **out}),
          flush=True)


def chain_ab(gpu: str, n_reads: int = 80000, batch: int = 1024) -> None:
    import bench
    from clique_tpu.chain import run_chain
    from clique_tpu.config.layout import SequenceLayout
    from clique_tpu.reference.manager import ReferenceManager

    with tempfile.TemporaryDirectory() as tmp:
        data = bench.write_dataset(tmp, n_reads)
        layout = SequenceLayout.from_yaml(data["layout"])
        rm = ReferenceManager.from_layout(layout)
        warm = os.path.join(tmp, "warm.fastq")
        with open(data["fastq"]) as src, open(warm, "w") as dst:
            for _ in range(4 * 9 * batch):
                dst.write(src.readline())

        def run(fill, fq):
            t0 = time.perf_counter()
            astats, _ = run_chain(
                layout, rm, os.path.join(tmp, "a.bam"),
                os.path.join(tmp, "c.bam"), read1=fq, batch_size=batch,
                alleles_path=os.path.join(tmp, "al.tsv"), fill=fill)
            return time.perf_counter() - t0, astats.aligned

        for fill in ("scan", "auto"):
            run(fill, warm)
        for fill in ("scan", "auto", "auto", "scan"):
            dt, aligned = run(fill, data["fastq"])
            print(json.dumps({
                "measure": "chain_reads_per_s", "fill":
                    "kernel" if fill == "auto" else "scan",
                "reads": n_reads, "aligned": aligned, "seconds": dt,
                "reads_per_s": n_reads / dt, "gpu": gpu}), flush=True)


def main(argv) -> None:
    from clique_tpu.utils.jaxcfg import device_report, enable_persistent_cache

    enable_persistent_cache()
    rep = device_report()
    if rep["platform"] != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {rep['platform']}")
    time_fill(rep["gpu"])
    if "--fill" not in argv:
        chain_ab(rep["gpu"])


if __name__ == "__main__":
    main(sys.argv[1:])
