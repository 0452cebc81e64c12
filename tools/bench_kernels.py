#!/usr/bin/env python
"""Kernel microbenchmarks (manual; one process on an otherwise idle GPU):

    python tools/bench_kernels.py [dp|cuda|wfa|hamming]

Reports DP fill+traceback cells/s, the CUDA fill's cells/s (GPU only),
WFA cells/s (equivalent n*m cells per alignment at 5% error), and
allowlist Hamming lookups/s as an int8 one-hot product.
"""

import sys
import time

import numpy as np


def _bench(fn, *args, warmup=1, iters=5):
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.time()
    for _ in range(iters):
        out = jax.block_until_ready(fn(*args))
    return (time.time() - t0) / iters, out


def bench_dp():
    from clique_tpu.align.batch import align_batch_device, scoring_to_params
    from clique_tpu.align.scoring import AffineScoring

    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    B, LR, LD = 256, 512, 640
    refs = rng.choice(bases, (B, LR)).astype(np.uint8)
    reads = rng.choice(bases, (B, LD)).astype(np.uint8)
    rl = np.full(B, LR, np.int32)
    dl = np.full(B, LD, np.int32)
    bw = np.maximum(rl, dl)
    params = scoring_to_params(AffineScoring.aligner_default())

    def run():
        res, _tb = align_batch_device(refs, reads, rl, dl, bw, params,
                                      n1=LR + 1, n2=LD + 1)
        return res.score

    dt, _ = _bench(run)
    cells = B * LR * LD
    print(f"dp fill+traceback: {dt*1000:.1f} ms/batch  "
          f"{cells/dt/1e9:.1f} Gcells/s  {B/dt:.0f} alignments/s")


def bench_cuda_fill():
    from clique_tpu.align.batch import scoring_to_params
    from clique_tpu.align.cuda_fill import cuda_fill
    from clique_tpu.align.scoring import AffineScoring

    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    B, LR, LD = 256, 511, 639
    n1, n2 = 512, 640
    refs = rng.choice(bases, (B, LR)).astype(np.uint8)
    reads = rng.choice(bases, (B, LD)).astype(np.uint8)
    rl = np.full(B, LR, np.int32)
    dl = np.full(B, LD, np.int32)
    params = scoring_to_params(AffineScoring.aligner_default())

    def run():
        words, corner = cuda_fill(refs, reads, rl, dl, params, n1=n1, n2=n2)
        return corner

    dt, _ = _bench(run)
    cells = B * LR * LD
    print(f"CUDA fill: {dt*1000:.1f} ms/batch  {cells/dt/1e9:.1f} Gcells/s")


def bench_wfa():
    from clique_tpu.align.wavefront import wfa_edit_batch

    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    B, L = 256, 512
    refs = rng.choice(bases, (B, L)).astype(np.uint8)
    reads = refs.copy()
    # 5% substitutions
    mask = rng.random((B, L)) < 0.05
    reads[mask] = rng.choice(bases, int(mask.sum()))
    rl = np.full(B, L, np.int32)

    def run():
        return wfa_edit_batch(refs, reads, rl, rl, n1=L, n2=L,
                              smax=int(0.2 * L))

    dt, out = _bench(run)
    cells = B * L * L  # equivalent-DP cells
    print(f"wfa edit (5% err): {dt*1000:.1f} ms/batch  "
          f"{cells/dt/1e9:.1f} equiv-Gcells/s  mean s={np.mean(out):.1f}")


def bench_hamming():
    from clique_tpu.collapse.distance import hamming_hits

    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    U, K, L = 4096, 65536, 16
    tags = [rng.choice(bases, L).tobytes() for _ in range(U)]
    allow = [rng.choice(bases, L).tobytes() for _ in range(K)]

    t0 = time.time()
    hamming_hits(tags, allow, 2)
    dt = time.time() - t0
    print(f"hamming vs allowlist: {U} tags x {K} entries in {dt:.2f}s "
          f"({U*K/dt/1e9:.1f} Gcomparisons/s)")


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("dp", "all"):
        bench_dp()
    if which in ("cuda", "all"):
        bench_cuda_fill()
    if which in ("wfa", "all"):
        bench_wfa()
    if which in ("hamming", "all"):
        bench_hamming()
