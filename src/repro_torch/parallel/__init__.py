"""Distribution of the port: named meshes over local and process rings
(``parallel.mesh``), ring attention with its memory-flat backward, the
ring matmul and GPipe stages over the mesh.  Counterpart of
``repro.parallel``; the sharding specs (``param_specs`` and the rest) are
not ported yet."""
from .mesh import (LocalRing, Mesh, ProcessRing, get_mesh, make_mesh,
                   make_process_mesh, set_mesh)
from .pipeline import pipeline_forward
from .ring_attention import ring_attention, ring_attention_local
from .ring_matmul import allgather_matmul, ring_matmul, ring_matmul_ref

__all__ = ["Mesh", "LocalRing", "ProcessRing", "make_mesh",
           "make_process_mesh", "set_mesh", "get_mesh", "ring_matmul",
           "ring_matmul_ref", "allgather_matmul", "ring_attention",
           "ring_attention_local", "pipeline_forward"]
