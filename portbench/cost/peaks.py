"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, dense rates without sparsity, at the full power limit)."""
from __future__ import annotations

from typing import Dict

#: H100 SXM5 80 GB: bf16 and fp16 tensor cores, TF32, float32 outside the
#: tensor cores, HBM3 bandwidth; at 700 W
H100_SXM = {"bf16_flops": 989e12, "tf32_flops": 495e12, "fp32_flops": 67e12,
            "hbm_bytes_per_s": 3.35e12, "power_w": 700.0}

#: device name (as ``torch.cuda.get_device_name`` gives it) -> peaks
BY_NAME = {"NVIDIA H100 80GB HBM3": H100_SXM}


def of(device_name: str) -> Dict[str, float]:
    """The peaks of a card by its name; an unknown card raises."""
    if device_name in BY_NAME:
        return BY_NAME[device_name]
    raise KeyError(f"no published peaks for {device_name!r}")


def roofline_s(flops: float, nbytes: float, peaks: Dict[str, float],
               rate: str = "bf16_flops") -> float:
    """The least time the card could take: the larger of the operations at
    ``rate`` and the bytes at the memory rate."""
    return max(flops / peaks[rate], nbytes / peaks["hbm_bytes_per_s"])
