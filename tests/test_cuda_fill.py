"""The CUDA DP fill (align/dp_fill.cu) and what surrounds it.

The kernel itself has no interpret mode, so on the CPU these tests cover
its algorithm through a NumPy transcription (per-row register carries,
the neighbour's previous diagonal through the exchange buffer, the read
indexed by y-1, the fresh-byte tail word) checked bit for bit against the
XLA scan, plus the choice of fill, the shard_map wrapper, the word layout
and the shape limits. Tests marked `gpu` run the kernel itself against the
scan; chip_smoke.py runs the same comparison at bench width.
"""

import numpy as np
import pytest

from clique_tpu.align import batch as dbatch
from clique_tpu.align.cuda_fill import MAX_ROWS, n_words
from clique_tpu.align.scoring import MAX_NEG_SCORE, AffineScoring

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
FRESH = 1 | (1 << 2) | (1 << 4)


def _batch(rng, B, n1, n2, shared_ref=False, n_rate=0.05):
    R = 1 if shared_ref else B
    refs = np.zeros((R, n1 - 1), np.uint8)
    reads = np.zeros((B, n2 - 1), np.uint8)
    ref_lens = np.zeros(B, np.int32)
    read_lens = np.zeros(B, np.int32)
    for r in range(R):
        lr = int(rng.integers(1, n1))
        refs[r, :lr] = rng.choice(BASES, lr)
        refs[r, :lr][rng.random(lr) < n_rate] = ord("N")
        ref_lens[slice(None) if shared_ref else r] = lr
    for b in range(B):
        ld = int(rng.integers(1, n2))
        reads[b, :ld] = rng.choice(BASES, ld)
        reads[b, :ld][rng.random(ld) < n_rate] = ord("N")
        read_lens[b] = ld
    return refs, reads, ref_lens, read_lens


def _three_way(up, left, diag):
    up_wins = (up > left) & (up > diag)
    left_wins = ~(up > left) & (left > diag)
    val = np.where(up_wins, up, np.where(left_wins, left, diag))
    d = np.where(up_wins, 1, np.where(left_wins, 2, 0)).astype(np.uint32)
    return val.astype(np.float32), d


def emulate_cuda_fill(refs, reads, ref_lens, read_lens, params, *, n1, n2,
                      special_mode):
    """dp_fill.cu transcribed to NumPy, one block (row b) at a time."""
    f32 = np.float32
    m_s, mm_s, sp_s, go, ge, fgm = (f32(v) for v in np.asarray(params))
    neg = f32(MAX_NEG_SCORE)
    B, read_w = reads.shape
    D = n1 + n2 - 1
    words = np.zeros((n_words(n1, n2), B, n1), np.uint32)
    corner = np.zeros((B, 3), f32)
    x = np.arange(n1)
    for b in range(B):
        ref = refs[0 if refs.shape[0] == 1 else b]
        rx = np.where((x >= 1) & (x - 1 < ref.shape[0]),
                      ref[np.clip(x - 1, 0, ref.shape[0] - 1)], 0)
        l1, l2 = int(ref_lens[b]), int(read_lens[b])
        yb = (go + x.astype(f32) * ge) * fgm
        exch = np.zeros((3, n1), f32)               # diagonal d-1, by row
        pm = pp1 = pp2 = np.zeros(n1, f32)
        s2m = s2p1 = s2p2 = np.zeros(n1, f32)
        word = np.zeros(n1, np.uint32)
        for d in range(D):
            sm, sp1, sp2 = (np.concatenate([[f32(0)], v[:-1]]) for v in exch)
            y = d - x
            ok = (y >= 1) & (y - 1 < read_w)
            ry = np.where(ok, reads[b, np.clip(y - 1, 0, read_w - 1)], 0)
            if special_mode == "ref_n_only":
                special = rx == 78
            elif special_mode == "none":
                special = np.zeros(n1, bool)
            else:
                special = (rx == 78) | (ry == 78) | (rx < 58) | (ry < 58)
            ms = np.where(special, sp_s, np.where(rx == ry, m_s, mm_s))
            gm = np.where((x == l1) | (y == l2), fgm, f32(1)).astype(f32)
            x1 = go + ge * gm
            lge = ge * gm
            m_val, m_dir = _three_way(s2p1 + ms, s2p2 + ms, s2m + ms)
            d_val, d_dir = _three_way(sp1 + lge, sp2 + x1, sm + x1)
            i_val, i_dir = _three_way(pp1 + x1, pp2 + lge, pm + x1)
            interior = (x >= 1) & (x <= l1) & (y >= 1) & (y <= l2)
            xbord = (x == 0) & (y >= 1) & (y <= l2)
            ybord = (y == 0) & (x >= 1) & (x <= l1)
            origin = (x == 0) & (y == 0)
            xb = (go + y.astype(f32) * ge) * fgm
            m_out = np.where(interior, m_val, np.where(
                origin, 0, np.where(xbord | ybord, neg, 0))).astype(f32)
            rest = np.where(xbord, xb, np.where(ybord, yb,
                                                np.where(origin, neg, 0)))
            p1_out = np.where(interior, d_val, rest).astype(f32)
            p2_out = np.where(interior, i_val, rest).astype(f32)
            tb = np.where(interior, m_dir | (d_dir << 2) | (i_dir << 4),
                          FRESH).astype(np.uint32)
            word |= tb << np.uint32(8 * (d & 3))
            if d & 3 == 3:
                words[d >> 2, b] = word
                word = np.zeros(n1, np.uint32)
            if d == l1 + l2:
                corner[b] = (m_out[l1], p1_out[l1], p2_out[l1])
            exch = np.stack([m_out, p1_out, p2_out])
            s2m, s2p1, s2p2 = sm, sp1, sp2
            pm, pp1, pp2 = m_out, p1_out, p2_out
        if D & 3:
            for k in range(D & 3, 4):
                word |= np.uint32(FRESH << (8 * k))
            words[D >> 2, b] = word
    return words.view(np.int32), corner


@pytest.mark.parametrize("special_mode,shared_ref,scoring", [
    ("both", False, AffineScoring.aligner_default()),
    ("ref_n_only", False, AffineScoring(1.0, -1.0, 1.0, -5.0, -1.0, 1.0)),
    ("ref_n_only", True, AffineScoring(1.0, -1.0, 1.0, -5.0, -1.0, 1.0)),
    ("none", False, AffineScoring.hifi_default()),
])
def test_kernel_algorithm_matches_scan_words(special_mode, shared_ref,
                                             scoring):
    """The kernel's formulation gives the scan's packed words and corner
    values bit for bit (ragged lengths, N bytes, a D not divisible by 4)."""
    rng = np.random.default_rng(11)
    n1, n2 = 33, 46                        # D = 78: a padded tail word
    refs, reads, rl, dl = _batch(rng, 6, n1, n2, shared_ref=shared_ref)
    params = dbatch.scoring_to_params(scoring)
    want_w, want_c = dbatch.scan_fill(refs, reads, rl, dl, params, n1=n1,
                                      n2=n2, special_mode=special_mode)
    got_w, got_c = emulate_cuda_fill(refs, reads, rl, dl, params, n1=n1,
                                     n2=n2, special_mode=special_mode)
    assert got_w.shape == (n_words(n1, n2), 6, n1)
    np.testing.assert_array_equal(got_w, np.asarray(want_w))
    np.testing.assert_array_equal(got_c.view(np.int32),
                                  np.asarray(want_c).view(np.int32))


def test_packed_words_roundtrip_to_traceback_bytes():
    """pack_words/unpack_words: the word layout the CUDA fill writes
    carries exactly the scan's traceback bytes, tail padded fresh."""
    rng = np.random.default_rng(5)
    n1, n2 = 17, 23
    refs, reads, rl, dl = _batch(rng, 4, n1, n2)
    params = dbatch.scoring_to_params(AffineScoring.aligner_default())
    bw = np.maximum(np.maximum(rl, dl), 1)
    _res, tb = dbatch.align_batch_device(refs, reads, rl, dl, bw, params,
                                         n1=n1, n2=n2)
    words, _c = dbatch.scan_fill(refs, reads, rl, dl, params, n1=n1, n2=n2)
    D = n1 + n2 - 1
    np.testing.assert_array_equal(
        np.asarray(dbatch.unpack_words(words, D)), np.asarray(tb))
    tail = (np.asarray(words)[-1] >> (8 * (D % 4))) & 0xFF
    assert (tail == FRESH).all()


@pytest.mark.parametrize("backend,kw,want", [
    ("gpu", dict(n1=384, batch=1024), "cuda"),
    ("gpu", dict(n1=MAX_ROWS, batch=32), "cuda"),
    ("gpu", dict(n1=MAX_ROWS + 128, batch=32), "scan"),
    ("gpu", dict(n1=384, batch=1024, banded=True), "scan"),
    ("gpu", dict(n1=384, batch=1024, local=True), "scan"),
    ("gpu", dict(n1=384, batch=64, mesh_size=4), "cuda"),
    ("gpu", dict(n1=384, batch=36, mesh_size=8), "scan"),
    ("cpu", dict(n1=384, batch=1024), "scan"),
    ("tpu", dict(n1=384, batch=1024), "scan"),
])
def test_select_fill(backend, kw, want):
    assert dbatch.select_fill(backend, **kw) == want


@pytest.mark.parametrize("fill,bandwidth,backend,want", [
    ("auto", None, "gpu", "cuda"),
    ("scan", None, "gpu", "scan"),
    ("auto", 16, "gpu", "scan"),
    ("auto", None, "cpu", "scan"),
])
def test_batch_aligner_fill_choice(fill, bandwidth, backend, want):
    from clique_tpu.align.pipeline import BatchAligner

    aligner = BatchAligner(AffineScoring.aligner_default(), batch_size=32,
                           bandwidth=bandwidth, fill=fill, use_mesh=False)
    aligner.backend = backend
    assert aligner._fill_for(128, 32) == want


def test_batch_aligner_rejects_unknown_fill():
    from clique_tpu.align.pipeline import BatchAligner

    with pytest.raises(ValueError):
        BatchAligner(AffineScoring.aligner_default(), fill="cuda")


def test_cuda_fill_refuses_too_many_rows():
    """More DP rows than threads in a block is refused before any build."""
    from clique_tpu.align.cuda_fill import cuda_fill

    rng = np.random.default_rng(0)
    refs, reads, rl, dl = _batch(rng, 2, MAX_ROWS + 2, 8)
    params = dbatch.scoring_to_params(AffineScoring.aligner_default())
    with pytest.raises(ValueError):
        cuda_fill(refs, reads, rl, dl, params, n1=MAX_ROWS + 2, n2=8)


@pytest.mark.parametrize("shared_ref", [True, False])
def test_shard_fill_wrapper_matches_unsharded(shared_ref):
    """The shard_map wrapper the CUDA fill runs under on a mesh, driven
    with the scan fill on the 8 virtual CPU devices: words shard on their
    batch axis, a one-row reference replicates."""
    import functools

    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    assert len(devices) == 8
    mesh = Mesh(np.array(devices), axis_names=("data",))
    rng = np.random.default_rng(3)
    n1, n2 = 24, 30
    refs, reads, rl, dl = _batch(rng, 16, n1, n2, shared_ref=shared_ref)
    params = dbatch.scoring_to_params(AffineScoring.aligner_default())
    fill = functools.partial(dbatch.scan_fill, n1=n1, n2=n2)
    sharded = jax.jit(dbatch._shard_fill(fill, mesh, shared_ref=shared_ref))
    got_w, got_c = sharded(refs, reads, rl, dl, params)
    want_w, want_c = fill(refs, reads, rl, dl, params)
    np.testing.assert_array_equal(np.asarray(got_w), np.asarray(want_w))
    np.testing.assert_array_equal(np.asarray(got_c), np.asarray(want_c))


@pytest.mark.gpu
@pytest.mark.parametrize("special_mode", ["both", "ref_n_only"])
def test_cuda_fill_matches_scan_on_card(special_mode):
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (the CUDA fill has no CPU mode)")
    rng = np.random.default_rng(17)
    n1, n2 = 128, 160
    refs, reads, rl, dl = _batch(rng, 64, n1, n2)
    params = dbatch.scoring_to_params(AffineScoring.aligner_default())
    bw = np.maximum(np.maximum(rl, dl), 1)
    kw = dict(n1=n1, n2=n2, special_mode=special_mode)
    res = {fill: dbatch.align_batch_device(refs, reads, rl, dl, bw, params,
                                           fill=fill, **kw)
           for fill in ("cuda", "scan")}
    for (a, tb_a), (b, tb_b) in [(res["cuda"], res["scan"])]:
        np.testing.assert_array_equal(np.asarray(tb_a), np.asarray(tb_b))
        for field in ("ops", "n_ops", "score", "ops_packed", "start_z"):
            np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                          np.asarray(getattr(b, field)))
