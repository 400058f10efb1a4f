"""Parallelism for the port: the sequence-parallel (`sp`) axis of
training and the tensor-parallel (`tp`) axis of serving.

Counterpart of skypilot_tpu/parallel/ for what the port runs: the ambient
sp context and the tp rules over the model's parameters (sharding.py),
process wiring over torchrun's variables and the spawned serving group
(distributed.py), the sp mesh inference and the serving group that
stands for `decode_mesh` (mesh.py). Pipeline, dp/ep/fsdp meshes and
ZeRO-1 are not ported yet.
"""
