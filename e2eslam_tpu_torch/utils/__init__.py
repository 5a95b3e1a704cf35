"""Utilities: the input-corruption toolkit and focal-length averaging."""

from e2eslam_tpu_torch._exports import lazy

__all__, __getattr__ = lazy(__name__, {
    "noise_depth": "corruption",
    "noise_color": "corruption",
    "remove_pixels": "corruption",
    "replace_image": "corruption",
    "corrupt_rgbd": "corruption",
})
