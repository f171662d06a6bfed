"""kaamer_tpu_torch: the PyTorch/CUDA port of kaamer_tpu.

Module paths mirror kaamer_tpu's, so each port module sits at the same
relative path as the JAX module it replaces.  The package stands alone: it
imports torch, never jax, and nothing of kaamer_tpu.  The host code it
needs (records, codec packers, readers, artifact and build, the native
packers, options, results formatting, matrices, the host SW DP, the
engine's planner and the protein pipeline, the server's form parsing) is
its own copy, with the JAX package's constants, tie rules and formats
unchanged.

Every device function takes its device explicitly (an engine is built for
one device; tensors carry theirs).  Nothing here picks a device on its own
or falls back from CUDA to the CPU: a CPU tensor runs the plain-torch
version of a kernel, a CUDA tensor runs the hand-written kernel or raises.
"""

__version__ = "0.1.0"

KMER_SIZE = 7  # fixed, as in the reference (makedb.go:30, search.go:45)
