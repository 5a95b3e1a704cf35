"""Published peaks of the cards the benchmark measures (NVIDIA's H100 SXM
data sheet, dense rates, at the 700 W limit): FLOP/s by the network's
compute dtype (float32 outside the tensor cores: the port turns TF32 off)
and HBM bytes/s."""

PEAKS = {
    "H100": {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peak(device_name: str, key: str):
    """The peak ``key`` of the card named ``device_name``; None for a card
    the table does not hold."""
    for card, table in PEAKS.items():
        if card in device_name:
            return table.get(key)
    return None
