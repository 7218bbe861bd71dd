"""Carbon-footprint model (paper §2.2 Formula 1, §6 Fig. 12/13).

CF = ECE + OCE
  ECE — embodied carbon, amortised over device lifespan by runtime share.
  OCE — operational carbon = energy(kWh) × grid carbon intensity.

Constants follow the paper's evaluation section: DRAM 26 W / 256 GB,
SSD 2 W, grid intensity 820 gCO2/kWh, plus published TDPs / embodied
estimates per accelerator (A100 embodied ≈150 kgCO2, Luccioni et al.).

Two accounting granularities:

* :func:`total_carbon` — one interval, one mean utilisation, one (constant)
  grid intensity. Used by the closed-loop ``generate()`` path.
* :class:`CarbonAccountant` + :class:`CarbonIntensityTrace` — step-level
  accounting for the serving scheduler: each scheduler iteration charges
  its clock delta at the grid intensity *of that moment*, so carbon-aware
  scheduling (shifting deferrable work into low-intensity windows, the
  EcoServe direction) actually shows up in gCO2/request. Power is linear
  in utilisation, so with a constant trace the accountant reproduces
  :func:`total_carbon` exactly.

Units throughout: seconds, watts, joules, gCO2, gCO2/kWh.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, Optional, Sequence

GRID_INTENSITY_G_PER_KWH = 820.0          # paper Fig. 13 caption
DRAM_W_PER_GB = 26.0 / 256.0              # paper Fig. 13 caption
SSD_W = 2.0                               # paper Fig. 13 caption
LIFESPAN_S = 5 * 365 * 24 * 3600.0        # 5-year amortisation
# an *active* server idles no lower than 0.25·TDP (streams, busy-wait,
# resident context); a *drained* one parks near hardware idle — published
# GPU idle draws are ~5-10 % of TDP. The gap between the two is what
# carbon-aware deferral harvests: park in the dirty window, serve in the
# clean one.
ACTIVE_POWER_FLOOR = 0.25
DEEP_IDLE_POWER_FRAC = 0.07


@dataclasses.dataclass(frozen=True)
class Device:
    name: str
    tdp_w: float            # operational power at inference load
    embodied_gco2: float    # manufacturing footprint
    hbm_gb: float


DEVICES: Dict[str, Device] = {
    # old-fashioned GPUs (the paper's deployment target)
    "m40": Device("m40", 250.0, 45_000.0, 24.0),
    "k40": Device("k40", 235.0, 40_000.0, 12.0),
    "rtx3090": Device("rtx3090", 350.0, 50_000.0, 24.0),
    "rtx4090": Device("rtx4090", 450.0, 60_000.0, 24.0),
    # top-tier GPUs
    "v100": Device("v100", 300.0, 100_000.0, 32.0),
    "a100": Device("a100", 400.0, 150_000.0, 80.0),
    "h100": Device("h100", 700.0, 160_000.0, 80.0),
    # the TPU target of this repo (per-chip)
    "tpu_v5e": Device("tpu_v5e", 200.0, 70_000.0, 16.0),
}


@dataclasses.dataclass(frozen=True)
class EnergyBreakdown:
    accelerator_j: float
    dram_j: float
    ssd_j: float

    @property
    def total_j(self) -> float:
        return self.accelerator_j + self.dram_j + self.ssd_j


def operational_carbon(energy: EnergyBreakdown,
                       intensity: float = GRID_INTENSITY_G_PER_KWH) -> float:
    """gCO2 from energy use."""
    kwh = energy.total_j / 3.6e6
    return kwh * intensity


def embodied_carbon(device: Device, runtime_s: float,
                    lifespan_s: float = LIFESPAN_S) -> float:
    """gCO2 amortised share of manufacturing footprint."""
    return device.embodied_gco2 * (runtime_s / lifespan_s)


def inference_energy(runtime_s: float, *, device: Device,
                     accelerator_util: float,
                     dram_gb: float, ssd_active: bool) -> EnergyBreakdown:
    """Energy for one serving interval.

    ``accelerator_util`` scales accelerator power with compute activity —
    MP Inference's FLOP reduction shows up here (paper: "MP Inference
    decreases computational carbon by using only a subset of neurons").
    """
    acc = device.tdp_w * (ACTIVE_POWER_FLOOR + (1.0 - ACTIVE_POWER_FLOOR)
                          * accelerator_util) * runtime_s
    dram = DRAM_W_PER_GB * dram_gb * runtime_s
    ssd = (SSD_W if ssd_active else 0.0) * runtime_s
    return EnergyBreakdown(acc, dram, ssd)


class CarbonIntensityTrace:
    """Piecewise-constant grid carbon intensity over the modeled clock.

    ``times`` are breakpoint seconds (sorted, starting at 0.0) and
    ``values`` the gCO2/kWh in effect from each breakpoint until the next;
    the last value holds forever. With ``period_s`` set the trace repeats
    (a synthetic diurnal cycle on the modeled clock).
    """

    def __init__(self, times: Sequence[float], values: Sequence[float],
                 *, period_s: Optional[float] = None):
        if len(times) != len(values) or not times:
            raise ValueError("times and values must be equal-length, non-empty")
        if list(times) != sorted(times) or times[0] != 0.0:
            raise ValueError("times must be sorted and start at 0.0")
        if period_s is not None and period_s < times[-1]:
            raise ValueError("period_s must cover the last breakpoint")
        self.times = [float(t) for t in times]
        self.values = [float(v) for v in values]
        self.period_s = period_s

    # -- constructors --------------------------------------------------
    @classmethod
    def constant(cls, g_per_kwh: float = GRID_INTENSITY_G_PER_KWH
                 ) -> "CarbonIntensityTrace":
        return cls([0.0], [g_per_kwh])

    @classmethod
    def square(cls, *, high: float = GRID_INTENSITY_G_PER_KWH,
               low: float = 100.0, high_s: float = 60.0,
               low_s: float = 60.0) -> "CarbonIntensityTrace":
        """Repeating high→low square wave (a compressed day/night cycle):
        intensity is ``high`` for ``high_s`` seconds, then ``low`` for
        ``low_s`` seconds, repeating."""
        return cls([0.0, high_s], [high, low], period_s=high_s + low_s)

    @classmethod
    def diurnal(cls, *, peak: float = GRID_INTENSITY_G_PER_KWH,
                trough: float = 100.0, period_s: float = 240.0,
                steps: int = 24) -> "CarbonIntensityTrace":
        """Sinusoidal day cycle sampled at ``steps`` piecewise-constant
        segments, starting at the peak (modeled-clock t=0 ≙ midday)."""
        times, values = [], []
        mid, amp = (peak + trough) / 2.0, (peak - trough) / 2.0
        for i in range(steps):
            times.append(period_s * i / steps)
            values.append(mid + amp * math.cos(2 * math.pi * i / steps))
        return cls(times, values, period_s=period_s)

    @classmethod
    def from_csv(cls, path: str, *,
                 period_s: Optional[float] = None) -> "CarbonIntensityTrace":
        """Load ``time_s,g_per_kwh`` rows (header optional)."""
        times, values = [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                a, b = line.split(",")[:2]
                try:
                    ta, vb = float(a), float(b)    # both, before appending
                except ValueError:
                    continue                       # header / malformed row
                times.append(ta)
                values.append(vb)
        return cls(times, values, period_s=period_s)

    # -- queries -------------------------------------------------------
    def intensity_at(self, t: float) -> float:
        """gCO2/kWh in effect at modeled second ``t``."""
        if self.period_s:
            t = t % self.period_s
        i = bisect.bisect_right(self.times, max(t, 0.0)) - 1
        return self.values[max(i, 0)]

    def _next_breakpoint_after(self, t: float) -> float:
        """Earliest breakpoint strictly after ``t`` (periodic unrolling);
        +inf for a non-periodic trace past its last breakpoint."""
        if self.period_s:
            base = math.floor(t / self.period_s) * self.period_s
            tt = t - base
        else:
            base, tt = 0.0, t
        for bp in self.times:
            if bp > tt + 1e-12:
                return base + bp
        return base + self.period_s if self.period_s else math.inf

    def integral(self, t0: float, t1: float) -> float:
        """Exact ∫ intensity dt over [t0, t1] (gCO2/kWh · s) — piecewise-
        constant segments summed, so long accounting slices that span
        several grid windows are priced correctly."""
        total = 0.0
        t = t0
        while t < t1:
            seg_end = min(self._next_breakpoint_after(t), t1)
            total += self.intensity_at(t) * (seg_end - t)
            t = seg_end
        return total

    def mean(self, t0: float, t1: float) -> float:
        """Time-weighted mean intensity over [t0, t1]."""
        if t1 <= t0:
            return self.intensity_at(t0)
        return self.integral(t0, t1) / (t1 - t0)

    def next_window_below(self, t: float, threshold: float,
                          horizon_s: float = 3600.0) -> Optional[float]:
        """Earliest time >= ``t`` with intensity <= ``threshold`` (scan of
        breakpoints up to ``horizon_s`` ahead); None if there is none.
        Schedulers use this to decide how long deferring work is worth it."""
        if self.intensity_at(t) <= threshold:
            return t
        if self.period_s is None:
            # non-periodic: the last value holds forever, so the only
            # candidate windows are the remaining breakpoints after t
            for bp, val in zip(self.times, self.values):
                if bp >= t and val <= threshold:
                    return bp if bp - t <= horizon_s else None
            return None
        period = self.period_s
        k0 = int(t // period)
        for k in range(k0, k0 + int(horizon_s // period) + 2):
            for bp, val in zip(self.times, self.values):
                cand = k * period + bp
                if cand >= t and val <= threshold:
                    return cand if cand - t <= horizon_s else None
        return None


class CarbonAccountant:
    """Step-level OCE/ECE integrator for the serving scheduler.

    ``charge(t0, dt, compute_s, dram_gb)`` books one scheduler iteration:
    ``dt`` modeled seconds starting at clock ``t0`` of which ``compute_s``
    were accelerator-busy, with ``dram_gb`` resident. Energy uses the same
    linear power model as :func:`inference_energy`; the OCE for the slice
    is priced at ``trace.intensity_at(t0)``. All inputs are modeled-clock
    seconds; outputs are joules and gCO2.
    """

    def __init__(self, *, device_name: str, ssd_active: bool,
                 trace: Optional[CarbonIntensityTrace] = None):
        self.device = DEVICES[device_name]
        self.ssd_active = ssd_active
        self.trace = trace or CarbonIntensityTrace.constant()
        self.accelerator_j = 0.0
        self.dram_j = 0.0
        self.ssd_j = 0.0
        self.oce_g = 0.0
        self._span = 0.0
        # optional obs hook: per-slice gCO2 / intensity counter samples
        # on the "carbon" track (recorder timestamps are *raw* engine
        # seconds; charge() gets run-rebased times, so the owner passes
        # its clock origin)
        self._recorder = None
        self._recorder_t0 = 0.0

    def attach_trace(self, recorder, *, t0: float = 0.0):
        """Emit a ``carbon`` counter sample per charged slice into
        ``recorder`` (a :class:`repro.obs.TraceRecorder`). ``t0`` is the
        raw-clock origin the caller's rebased slice times add to."""
        self._recorder = recorder
        self._recorder_t0 = float(t0)

    def charge(self, t0: float, dt: float, compute_s: float,
               dram_gb: float, *, active: bool = True) -> float:
        """Book one slice; returns the slice's operational gCO2 so the
        caller can attribute it (per request / per phase).
        ``active=False`` marks a drained interval (no request in
        flight): the accelerator parks at deep idle instead of the
        active floor — the state a carbon policy puts the server in
        during dirty-grid windows."""
        if dt <= 0.0:
            return 0.0
        util = min(compute_s / dt, 1.0)
        frac = (ACTIVE_POWER_FLOOR + (1.0 - ACTIVE_POWER_FLOOR) * util) \
            if active else DEEP_IDLE_POWER_FRAC
        acc = self.device.tdp_w * frac * dt
        dram = DRAM_W_PER_GB * dram_gb * dt
        ssd = (SSD_W if self.ssd_active else 0.0) * dt
        # power is constant within the slice; the grid intensity may not
        # be — integrate it so multi-window slices are priced exactly
        weighted = self.trace.integral(t0, t0 + dt)
        slice_g = (acc + dram + ssd) / dt / 3.6e6 * weighted
        self.accelerator_j += acc
        self.dram_j += dram
        self.ssd_j += ssd
        self.oce_g += slice_g
        self._span += dt
        if self._recorder is not None:
            self._recorder.counter(
                "carbon", "gco2", self._recorder_t0 + t0 + dt,
                oce_g=self.oce_g, slice_g=slice_g)
            self._recorder.counter(
                "carbon", "grid_intensity", self._recorder_t0 + t0,
                g_per_kwh=self.trace.intensity_at(t0))
        return slice_g

    def totals(self, *, include_embodied: bool = True) -> Dict[str, float]:
        """Same keys as :func:`total_carbon`, plus the **energy-weighted**
        mean grid intensity — the gCO2/kWh the run's joules actually paid.
        (A time-weighted mean is the same for every policy on a fixed
        window; the energy-weighted one drops when a policy shifts energy
        into clean windows, which is the point.)"""
        ece = embodied_carbon(self.device, self._span) \
            if include_embodied else 0.0
        total_j = self.accelerator_j + self.dram_j + self.ssd_j
        return {"oce_g": self.oce_g, "ece_g": ece,
                "total_g": self.oce_g + ece, "energy_j": total_j,
                "accelerator_j": self.accelerator_j, "dram_j": self.dram_j,
                "ssd_j": self.ssd_j,
                "mean_intensity_g_kwh":
                    self.oce_g / (total_j / 3.6e6) if total_j else 0.0}


def total_carbon(runtime_s: float, *, device_name: str,
                 accelerator_util: float, dram_gb: float,
                 ssd_active: bool,
                 intensity: float = GRID_INTENSITY_G_PER_KWH,
                 include_embodied: bool = True) -> Dict[str, float]:
    dev = DEVICES[device_name]
    e = inference_energy(runtime_s, device=dev,
                         accelerator_util=accelerator_util,
                         dram_gb=dram_gb, ssd_active=ssd_active)
    oce = operational_carbon(e, intensity)
    ece = embodied_carbon(dev, runtime_s) if include_embodied else 0.0
    return {"oce_g": oce, "ece_g": ece, "total_g": oce + ece,
            "energy_j": e.total_j, "accelerator_j": e.accelerator_j,
            "dram_j": e.dram_j, "ssd_j": e.ssd_j}
