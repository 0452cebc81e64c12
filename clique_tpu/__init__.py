"""clique_tpu — an amplicon / lineage-barcode analysis engine in JAX.

A from-scratch re-design of the capabilities of mckennalab/clique
built as batched device work on JAX / XLA, with a CUDA DP fill on GPUs:

- batched affine-gap DP alignment of reads against YAML-templated amplicon
  references runs as anti-diagonal wavefront kernels
  (``clique_tpu.align``),
- UMI / static-barcode collapsing is massively-parallel edit-distance
  clustering + consensus in JAX (``clique_tpu.collapse``,
  ``clique_tpu.consensus``),
- the event caller emits GESTALT-style lineage alleles
  (``clique_tpu.caller``),
- multi-device scaling via ``jax.sharding.Mesh`` data-parallel read batches
  (``clique_tpu.parallel``).

Host-side orchestration (config parsing, FASTQ/SAM/BAM IO, reference
management) lives in pure Python / C++ and stays off the device.
"""

__version__ = "0.1.0"
