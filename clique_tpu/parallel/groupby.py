"""Distributed tag group-by: the multi-host collapse backbone.

The reference's shardio external-memory sort (collapse.rs:468-469) is a
single-node construct; across hosts the same operation becomes (SURVEY 2.11 P4,
BASELINE north star):

1. each host extracts tags locally and hashes each read's current tag key
   into one of N buckets;
2. per-bucket histograms are psum-merged across the `data` mesh axis (a
   collective - `bucket_histogram` below);
3. buckets are deterministically assigned to owner hosts balanced by count
   (`assign_bucket_owners`);
4. an all-to-all exchange co-locates each bucket's reads on its owner
   (host-side shuffle; on one host this is the in-process exchange
   `exchange_by_owner` used by tests), after which every UMI group lives
   entirely on one host and the per-level correction runs locally.

Grouping by hash bucket is exact: all reads sharing a tag key share its
bucket, so no group is ever split across owners.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def tag_bucket(tag: bytes, n_buckets: int) -> int:
    """Deterministic FNV-1a bucket of a tag key (stable across hosts)."""
    h = 0xCBF29CE484222325
    for b in tag:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h % n_buckets


def bucket_histogram(mesh: Mesh, buckets: np.ndarray, n_buckets: int
                     ) -> np.ndarray:
    """psum-merged per-bucket counts over the data axis: buckets [B] int32
    sharded over 'data' -> histogram [n_buckets] replicated."""
    data = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())

    @functools.partial(jax.jit, in_shardings=(data,), out_shardings=repl)
    def hist(b):
        return jnp.sum(
            jax.nn.one_hot(b, n_buckets, dtype=jnp.int32), axis=0)

    return np.asarray(hist(buckets.astype(np.int32)))


def assign_bucket_owners(histogram: np.ndarray, n_hosts: int) -> np.ndarray:
    """Greedy balanced assignment of buckets to hosts by descending count;
    deterministic (ties break to lower bucket id / lower host id)."""
    order = sorted(range(len(histogram)), key=lambda b: (-histogram[b], b))
    load = [0] * n_hosts
    owner = np.zeros(len(histogram), dtype=np.int32)
    for b in order:
        h = min(range(n_hosts), key=lambda i: (load[i], i))
        owner[b] = h
        load[h] += int(histogram[b])
    return owner


def exchange_by_owner(per_host_items: List[List], keys: List[List[bytes]],
                      owner: np.ndarray, n_buckets: int
                      ) -> List[List]:
    """In-process stand-in for the cross-host all-to-all: route every item
    to its bucket's owner host. Across hosts this is a jax all_to_all /
    host-side gRPC shuffle with identical routing."""
    n_hosts = len(per_host_items)
    out: List[List] = [[] for _ in range(n_hosts)]
    for h in range(n_hosts):
        for item, key in zip(per_host_items[h], keys[h]):
            b = tag_bucket(key, n_buckets)
            out[int(owner[b])].append(item)
    return out


def distributed_group_keys(mesh: Mesh, per_host_keys: List[List[bytes]],
                           n_buckets: int = 1024
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Full pattern: per-host keys -> psum histogram -> owner map.
    Returns (histogram, owner)."""
    n_hosts = len(per_host_keys)
    all_buckets = []
    for keys in per_host_keys:
        all_buckets.extend(tag_bucket(k, n_buckets) for k in keys)
    total = len(all_buckets)
    # pad to a multiple of the mesh size for even sharding
    pad = (-total) % mesh.devices.size
    arr = np.array(all_buckets + [0] * pad, dtype=np.int32)
    hist = bucket_histogram(mesh, arr, n_buckets)
    if pad:
        hist[0] -= pad
    owner = assign_bucket_owners(hist, n_hosts)
    return hist, owner
