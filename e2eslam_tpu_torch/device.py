"""Device selection and float32 precision for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU: ``"cpu"`` (an
explicit argument or ``SETTINGS.device: cpu``) selects the CPU, any other
value selects CUDA. Asking for CUDA without a card raises; nothing falls
back to the CPU silently.
"""

from __future__ import annotations

import torch


def resolve_device(device=None, config=None) -> torch.device:
    """The device an entry point runs on.

    ``device`` (argument) wins over ``config.SETTINGS.device``. ``"cpu"``
    means the CPU; anything else (``None``, ``"cuda"``, the shipped config's
    ``tpu``) means CUDA, which must be available.
    """
    if device is None and config is not None:
        device = config.get("SETTINGS", {}).get("device")
    if device is not None and str(device) == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} selects CUDA, but torch.cuda.is_available() "
            "is False; pass device='cpu' (or SETTINGS.device: cpu) to run "
            "on the CPU"
        )
    return torch.device(device if str(device).startswith("cuda") else "cuda")


def set_full_fp32() -> None:
    """Full float32 everywhere: no TF32 in matmuls or cuDNN convolutions.

    ``SETTINGS.compute_dtype: float32`` means full fp32; PyTorch's cuDNN
    default is TF32 (about three decimal digits), which would change the
    CNN's numbers against the reference.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
