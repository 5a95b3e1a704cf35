"""Exact KNN (dispatcher, CUDA kernels, plain versions) and the Morton sort.

``knn`` names the module ``ops/knn.py`` (its dispatcher is ``knn.knn``,
the JAX package's ``ops.knn``); the JAX package's Pallas entry
``knn_pallas`` is the CUDA kernels' wrappers ``KERNELS`` here, its XLA
fallback ``knn_xla`` the plain version ``dense_plain``."""

from e2eslam_tpu_torch._exports import lazy

__all__, __getattr__ = lazy(__name__, {
    "knn": None,
    "KERNELS": "knn",
    "dense_plain": "knn",
    "knn_map_sharded": "knn_sharded",
    "shard_map_rows": "knn_sharded",
})
