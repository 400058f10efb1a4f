"""Parallelism for the port: the sequence-parallel (`sp`) axis only.

Counterpart of skypilot_tpu/parallel/ for what sequence-parallel training
needs: the ambient sp context (sharding.py), process wiring over
torchrun's variables (distributed.py) and the sp part of the mesh
inference (mesh.py). Pipeline, tp/ep/fsdp meshes and ZeRO-1 are not
ported yet.
"""
