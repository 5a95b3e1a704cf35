"""The refinement engine, the optimizers and the online-adaptation runner.

The JAX package's ``RefineState`` (the functional step's parameters,
optimizer state and step count) has no class here: ``RefinementEngine``
holds them."""

from e2eslam_tpu_torch._exports import lazy

__all__, __getattr__ = lazy(__name__, {
    "make_optimizer": "optim",
    "make_lr_schedule": "optim",
    "RefinementEngine": "refine",
    "PairBatch": "refine",
    "OnlineAdaptation": "adaptation",
})
