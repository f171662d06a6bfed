"""kaamer_tpu_torch: the PyTorch/CUDA port of kaamer_tpu.

Module paths mirror kaamer_tpu's, so each port module sits at the same
relative path as the JAX module it replaces.  Host code of kaamer_tpu that
never imports JAX (artifact, build, readers, options, results formatting,
matrices, the native packers) is shared by import, not copied; this package
itself imports torch and never jax.

Every device function takes its device explicitly (an engine is built for
one device; tensors carry theirs).  Nothing here picks a device on its own
or falls back from CUDA to the CPU: a CPU tensor runs the plain-torch
version of a kernel, a CUDA tensor runs the hand-written kernel or raises.
"""
