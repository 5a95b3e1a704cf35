"""Synthetic and ICL-NUIM/TUM RGB-D sequences, windowing and batching."""

from e2eslam_tpu_torch._exports import lazy

__all__, __getattr__ = lazy(__name__, {
    "SyntheticDataset": "synthetic",
    "ICLDataset": "tumicl",
    "TUMDataset": "tumicl",
    "load_batch": "pipeline",
    "make_dataset": "pipeline",
    "prefetch_batches": "pipeline",
    "ArrayDataset": "pipeline",
})
