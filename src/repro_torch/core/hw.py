"""Hardware constants of the modeled transfer clock.

These model the paper's testbed (an RTX 3090 behind PCIe 3.0 with an NVMe
SSD, paper §6.2). They are a *model* that the engine's clock prices bytes
and FLOPs with, kept identical to ``repro/core/hw.py`` so the port
reproduces the reference's modeled clock exactly. They are not measurements
of the card the port runs on.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HostHW:
    """The paper's old-fashioned server (§6.2) — modeled, not measured."""
    hbm_bw: float = 936e9          # RTX 3090 HBM bandwidth, B/s
    pcie_bw: float = 16e9          # HBM<->DRAM (PCIe 3.0 x16 effective)
    ssd_bw: float = 3.5e9          # DRAM<->SSD (PCIe 3.0 x4 NVMe)
    flops: float = 35.6e12         # 3090 fp16 with fp32 acc
    mem_util: float = 0.8          # achievable fraction of peak bandwidth
    flop_util: float = 0.45        # achievable fraction of peak FLOPs
    # small-transfer penalty observed in paper Fig. 5: neuron-granular
    # copies on HBM reach only a fraction of peak
    hbm_small_copy_bw: float = 30e9
    # effective fraction of PCIe bandwidth for scattered neuron-sized
    # (≈13–40 KB) DRAM→HBM transfers (paper Fig. 5's small-copy penalty)
    pcie_scatter_eff: float = 0.25
    # per-kernel launch latency: every separately-dispatched decode graph
    # pays this once per layer
    kernel_launch_s: float = 5e-6


HOST = HostHW()


@dataclasses.dataclass(frozen=True)
class H100:
    """The card the port runs on (NVIDIA H100 SXM5 80 GB, data-sheet peaks
    at 700 W): the roofline's rates (``roofline/analysis.py``) and the
    bounds of ``chip_smoke.py``. Every fp32 product of the port runs with
    TF32 off, so the roofline's compute term divides by ``flops_fp32``; a
    bound of work on bf16 operands divides by ``flops_bf16``."""
    name: str = "NVIDIA H100 80GB HBM3"
    hbm_bw: float = 3.35e12        # B/s
    flops_fp32: float = 67e12      # FLOP/s, CUDA cores
    flops_tf32: float = 495e12     # FLOP/s, dense tensor cores
    flops_bf16: float = 989e12     # FLOP/s, dense tensor cores
    link_bw: float = 450e9         # B/s a direction, NVLink 4 (18 links)


H100_SXM = H100()
