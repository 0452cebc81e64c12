"""The Hopper DP fill (dp_fill.cu) as a JAX operation.

The global, full-band fill of align/batch.py's anti-diagonal scan as one
CUDA kernel: a block per alignment, a thread per DP row, the diagonal loop
inside the block, the score planes in registers and shared memory. It
returns what the scan's packed walk consumes - int32 traceback words
[ceil(D/4), B, n1] and corner values [B, 3] - bit-identical to the scan.

The shared library is built from dp_fill.cu with nvcc at first use (or
ahead of time with `python -m clique_tpu.align.cuda_fill`) into
`_dp_fill.so` beside the source. A failed build or load raises: the GPU
path never falls back to the scan on its own.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np

from clique_tpu.align.scoring import MAX_NEG_SCORE

TARGET = "clique_dp_fill"
MAX_ROWS = 1024          # one thread per DP row, one block per alignment
SPECIAL_MODES = {"both": 0, "ref_n_only": 1, "none": 2}

_SRC = os.path.join(os.path.dirname(__file__), "dp_fill.cu")
_LIB = os.path.join(os.path.dirname(__file__), "_dp_fill.so")
_lock = threading.Lock()
_registered = False


def n_words(n1: int, n2: int) -> int:
    """Packed traceback words per DP row: 4 diagonals per int32."""
    return -(-(n1 + n2 - 1) // 4)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA DP fill cannot be built")


def build() -> str:
    """Compile dp_fill.cu for sm_90a unless the library is up to date.
    The library is written under a temporary name and renamed into place,
    so processes building at once never load a half-written file."""
    if os.path.exists(_LIB) and \
            os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return _LIB
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_LIB))
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-fmad=false", "-shared",
           "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir(),
           "-o", tmp, _SRC]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {_SRC}:\n{res.stderr[-4000:]}")
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _LIB


def register() -> None:
    """Build (if needed), load and register the FFI target once."""
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.CliqueDpFill), platform="CUDA")
        _registered = True


def cuda_fill(refs, reads, ref_lens, read_lens, scoring_params, *,
              n1: int, n2: int, special_mode: str = "both"):
    """refs [B|1, >= n1-1] uint8 (one row = shared by the batch), reads
    [B, W] uint8, lens [B] int32, scoring_params [6] f32 ->
    (words [ceil(D/4), B, n1] int32, corner [B, 3] f32)."""
    if n1 > MAX_ROWS:
        raise ValueError(f"the CUDA fill takes n1 <= {MAX_ROWS}, got {n1}")
    register()
    B = reads.shape[0]
    params = jnp.concatenate([
        jnp.asarray(scoring_params, jnp.float32).reshape(6),
        jnp.array([MAX_NEG_SCORE], jnp.float32)])
    return jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((n_words(n1, n2), B, n1), jnp.int32),
         jax.ShapeDtypeStruct((B, 3), jnp.float32)),
    )(jnp.asarray(refs, jnp.uint8), jnp.asarray(reads, jnp.uint8),
      jnp.asarray(ref_lens, jnp.int32), jnp.asarray(read_lens, jnp.int32),
      params, n1=np.int64(n1), n2=np.int64(n2),
      special_mode=np.int32(SPECIAL_MODES[special_mode]))


if __name__ == "__main__":
    print(build())
