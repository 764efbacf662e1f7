"""foldseek_tpu_torch: the PyTorch + CUDA port of foldseek_tpu.

The port runs the `easy-search --gpu 1` path (ungapped prefilter, then
dual-alphabet Smith-Waterman scoring, host backtraces and TM/LDDT gates) and
`--prefilter-mode 3` (gapped 3Di scoring of every query against the whole
target DB) with hand-written CUDA kernels for an NVIDIA Hopper card (csrc/),
and the plain PyTorch version of every kernel for CPU tensors. The package
stands alone: the host layers (DB storage, createdb, parameters, E-values,
output formatting, the binding of the native host library) are its own
copies of `foldseek_tpu`'s, under the same module names, and nothing here
imports `foldseek_tpu` or jax.
"""
