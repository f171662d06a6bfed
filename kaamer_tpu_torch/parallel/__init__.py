"""Sharded multi-device serving (kaamer_tpu/parallel): the per-shard index
(mesh.py), the collectives over a list of per-shard tensors (comm.py) and
the sharded engine on a (dp, shard) grid of torch devices (dist.py)."""
