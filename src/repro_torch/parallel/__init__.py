"""Distribution of the port: named meshes over local and process rings
(``parallel.mesh``: hops, sums, all-gathers and the all-to-all that
carries the MoE's tokens to their experts, ``models.layers.moe_ep_local``),
the sharding rules (``parallel.sharding``: the reference's specs as tuples
of mesh-axis names, their DTensor placements, each rank's local shapes,
and the placed trees of ``shard_tree`` / ``gather_tree``), Megatron's
conjugates and the vocabulary-parallel terms over a transport
(``parallel.tensor_parallel``), ring attention with its memory-flat
backward, the ring matmul and GPipe stages over the mesh.  Counterpart of
``repro.parallel``.  A state placed by its specs trains and serves
tensor- and data-parallel on local rings and on processes; a whole state
under a mesh of local rings takes the context-parallel ring."""
from .mesh import (LocalRing, Mesh, ProcessRing, get_mesh, make_mesh,
                   make_process_mesh, set_mesh)
from .pipeline import pipeline_forward
from .ring_attention import ring_attention, ring_attention_local
from .ring_matmul import allgather_matmul, ring_matmul, ring_matmul_ref
from .sharding import (Placed, batch_specs, cache_specs, gather_tree,
                       local_shape, make_shardings, paged_pool_specs,
                       param_specs, placements, shard_tree)

__all__ = ["Mesh", "LocalRing", "ProcessRing", "make_mesh",
           "make_process_mesh", "set_mesh", "get_mesh", "ring_matmul",
           "ring_matmul_ref", "allgather_matmul", "ring_attention",
           "ring_attention_local", "pipeline_forward", "param_specs",
           "batch_specs", "cache_specs", "paged_pool_specs",
           "make_shardings", "placements", "local_shape", "Placed",
           "shard_tree", "gather_tree"]
