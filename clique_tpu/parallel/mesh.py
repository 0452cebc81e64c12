"""Multi-device scaling: device mesh + data-parallel align step.

The reference engine is single-node shared-memory (SURVEY 2.11); its rayon
read-loop fanout becomes a flat 1-D `data` mesh over all devices (the
cards of one host are joined all to all by NVLink, so the mesh follows the
algorithm alone):

- read batches are sharded over `data` (each device aligns its shard with
  the batched DP kernel);
- the amplicon reference panel is replicated per device;
- cross-device aggregations (per-reference assignment histograms here;
  per-tag group histograms for the collapse stage) are psum collectives.

This module is exercised on a virtual CPU mesh in tests and on four GPUs
by `chip_smoke.py --four-cards` (dryrun_multichip).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from clique_tpu.align.batch import align_batch_device


def make_mesh(n_devices: int = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        assert len(devices) >= n_devices, (
            f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.array(devices), axis_names=("data",))


def length_sharded_align(mesh: Mesh, refs, reads, ref_lens, read_lens,
                         params, *, n1: int, n2: int):
    """Length-sharding of long DP problems (SURVEY 2.11 P6 / section 5):
    ONE alignment too big for a device runs with the DP's reference-lane
    axis sharded across the mesh. The anti-diagonal fill's only cross-lane
    communication is the one-lane systolic shift per diagonal
    (align/batch.py `_shift_down` and the read-byte window), which XLA
    SPMD lowers to a halo exchange (CollectivePermute) between
    neighboring devices - splitting one wavefront across devices. Batch axis replicated; results identical to the
    single-device fill."""
    data = NamedSharding(mesh, P(None, "data"))   # shard lanes, not batch
    repl = NamedSharding(mesh, P())

    @functools.partial(
        jax.jit,
        in_shardings=(data, repl, repl, repl, repl),
        out_shardings=(repl, repl, repl),
    )
    def step(refs, reads, ref_lens, read_lens, params):
        bw = jnp.maximum(ref_lens, read_lens)
        result, _tb = align_batch_device(
            refs, reads, ref_lens, read_lens, bw, params, n1=n1, n2=n2)
        return result.score, result.ops, result.n_ops

    return step(refs, reads, ref_lens, read_lens, params)


def sharded_align_step(mesh: Mesh, refs, reads, ref_lens, read_lens, params,
                       *, n1: int, n2: int):
    """One data-parallel align step over the mesh: batches sharded over
    'data', scoring params replicated. Returns (scores [B], ops [B,T],
    n_ops [B]) with the batch axis still sharded. The collapse stage's
    cross-device aggregation (per-tag bucket histograms) runs as a separate
    collective over the same mesh - parallel/groupby.bucket_histogram."""
    data = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())

    @functools.partial(
        jax.jit,
        in_shardings=(data, data, data, data, repl),
        out_shardings=(data, data, data),
    )
    def step(refs, reads, ref_lens, read_lens, params):
        bw = jnp.maximum(ref_lens, read_lens)
        result, _tb = align_batch_device(
            refs, reads, ref_lens, read_lens, bw, params, n1=n1, n2=n2)
        return result.score, result.ops, result.n_ops

    return step(refs, reads, ref_lens, read_lens, params)
