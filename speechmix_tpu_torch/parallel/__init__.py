"""Parallelism of the port on torch.distributed: the mesh (data / model /
seq), its sharding plan and the explicit collectives."""
