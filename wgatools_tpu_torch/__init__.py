"""wgatools_tpu_torch: the CIGAR engine of wgatools_tpu on PyTorch and CUDA.

A port of the JAX/TPU package `wgatools_tpu` to an NVIDIA H100, beside it:

- Host layer: the TPU package's jax-free readers, writers, CIGAR helpers
  and C++ host kernels (`wgatools_tpu.io`, `.core`, `.native`) are imported,
  not copied.
- Kernels: hand-written CUDA C++ for sm_90a under `csrc/`, built and bound
  by `kernels._build`, each with a plain PyTorch version beside its wrapper
  in `ops` (a CPU tensor takes the plain version).
- Tools: the device branches of `stat` (MAF and PAF), `call` (MAF),
  `maf2paf`, `maf2chain`, `paf2chain`, `chain2paf`, `pafcov` and
  `validate`, byte-identical to the TPU package's host engine; `python -m
  wgatools_tpu_torch` is the command line for every subcommand (the rest
  run the TPU package's host code).
- Sharded layer: `parallel`, on torch.distributed (one process per rank).

The package imports torch and never jax.
"""

from wgatools_tpu import __version__  # noqa: F401
