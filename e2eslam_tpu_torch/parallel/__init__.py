"""Several sequences at once: the mesh, the lockstep refinement step and the
multi-sequence runner.

The JAX package's ``shard_leading`` (a pytree's leading axis placed over
the mesh) is ``local_rows`` here (each rank keeps its own rows); its
``replicate`` needs no counterpart call: each rank of a ``Mesh`` is a
process that holds whole values."""

from e2eslam_tpu_torch._exports import lazy

__all__, __getattr__ = lazy(__name__, {
    "make_mesh": "mesh",
    "ParallelRefinement": "mesh",
    "Mesh": "mesh",
    "ParallelState": "mesh",
    "local_rows": "mesh",
    "ParallelAdaptation": "adaptation",
})
