"""The depth networks and their weight bridges.

The JAX package's ``init_depth_model`` (flax's variable initialisation)
and ``convert_torch_state_dict`` (a torch state dict into flax trees) are
``init_weights`` and ``load_state_dict_into`` here."""

from e2eslam_tpu_torch._exports import lazy

__all__, __getattr__ = lazy(__name__, {
    "ResnetEncoder": "resnet",
    "DepthDecoder": "decoders",
    "IndoorDepthDecoder": "decoders",
    "DispResNetIndoor": "depth_net",
    "MonodepthNet": "depth_net",
    "AffineScale": "depth_net",
    "ScaleLayer": "depth_net",
    "make_depth_model": "depth_net",
    "init_weights": "depth_net",
    "load_torch_checkpoint": "convert",
    "load_state_dict_into": "convert",
    "from_jax_params": "convert",
    "from_jax_params_stacked": "convert",
})
