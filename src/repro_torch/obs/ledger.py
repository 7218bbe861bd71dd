"""Modeled-time + gCO2 conservation ledger.

Every modeled second of a serving run's horizon — and every operational
gram of CO2 the :class:`~repro_torch.core.carbon.CarbonAccountant` books — is
attributed to exactly one **exclusive category**:

==========================  =================================================
category                    what it covers
==========================  =================================================
``prefill_compute/b<N>``    prefill engine-step time net of stalls, one
                            sub-key per dispatch-group batch size ``N``
``decode_compute/b<N>``     decode engine-step time net of stalls, per
                            dispatch-group batch size
``weight_stall``            weight-stream SSD→DRAM stalls the compute front
                            caught (``StepReport.stall_s`` net of retransfer)
``kv_stall``                KV residency charges: ``ensure_resident`` /
                            ``extend`` / ``append_token`` / ``swap_out``
``dma_retransfer``          synchronous redo time after injected in-flight
                            DMA failures (carved out of the stall category
                            it would otherwise hide in)
``recovery_reprefill``      the prefill-compute share spent re-prefilling
                            recovered requests after an unrecoverable KV
                            block loss
``idle``                    scheduler idle waits between arrivals
``trailing_idle``           horizon left after the last request finished
``other/...``               any residual a split could not place (should
                            stay ~0; nonzero values localise billing bugs)
==========================  =================================================

The **conservation invariant** is the point: the category sums must
reproduce the horizon (time) and the accountant's operational total
(gCO2) to within ``tolerance`` (default 0.1%). A scheduler change that
advances the clock without billing the ledger — or bills the same charge
twice — shows up as residue, so the ledger doubles as a standing audit
on the billing code.

The ledger also streams its running totals as cumulative ``ledger``
counter samples into a :class:`~repro_torch.obs.trace.TraceRecorder`, so
``scripts/perf_report.py`` can rebuild the full attribution from a trace
file alone (:func:`reconstruct`) — robust to ring-buffer truncation
because only the *last* cumulative sample matters.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

#: top-level ("family") time categories; per-dispatch-group sub-keys are
#: spelled ``family/b<batch>``
TIME_FAMILIES = (
    "prefill_compute", "decode_compute", "weight_stall", "kv_stall",
    "dma_retransfer", "recovery_reprefill", "idle", "trailing_idle",
    "other",
)

DEFAULT_TOLERANCE = 1e-3          # residue < 0.1% of horizon


def _family(category: str) -> str:
    return category.split("/", 1)[0]


class TimeLedger:
    """Exclusive-category attribution of modeled seconds and gCO2 grams.

    Billing is additive and order-free; ``close()`` fixes the horizon
    (and run span) the time categories must conserve, and
    ``set_carbon_total()`` fixes the gCO2 target. Negative charges are
    rejected — a negative delta always means a billing bug upstream.
    """

    def __init__(self, *, tolerance: float = DEFAULT_TOLERANCE):
        self.tolerance = float(tolerance)
        self.time_s: Dict[str, float] = {}
        self.gco2_g: Dict[str, float] = {}
        self.span_s: Optional[float] = None      # last-event run span
        self.horizon_s: Optional[float] = None   # max(span, horizon arg)
        self.gco2_total_g: Optional[float] = None
        self.embodied_g = 0.0

    # -- billing -------------------------------------------------------
    def bill(self, category: str, dt: float) -> None:
        """Attribute ``dt`` modeled seconds to ``category``."""
        if dt < 0.0:
            raise ValueError(
                f"negative time charge {dt!r} for {category!r}")
        if dt:
            self.time_s[category] = self.time_s.get(category, 0.0) + dt

    def bill_g(self, category: str, grams: float) -> None:
        """Attribute ``grams`` operational gCO2 to ``category``."""
        if grams < 0.0:
            raise ValueError(
                f"negative gCO2 charge {grams!r} for {category!r}")
        if grams:
            self.gco2_g[category] = self.gco2_g.get(category, 0.0) + grams

    def close(self, *, span_s: float, horizon_s: Optional[float] = None,
              gco2_total_g: Optional[float] = None,
              embodied_g: float = 0.0) -> None:
        """Fix the conservation targets: the run span (clock delta of the
        whole run), the horizon (>= span when a ``--horizon`` outlives the
        last request), the accountant's operational total, and the
        embodied share (reported separately — it amortises by wall share,
        not by activity, so it has no per-category attribution)."""
        self.span_s = float(span_s)
        self.horizon_s = max(float(span_s), float(horizon_s or 0.0))
        if gco2_total_g is not None:
            self.gco2_total_g = float(gco2_total_g)
        self.embodied_g = float(embodied_g)

    # -- queries -------------------------------------------------------
    def time_total(self) -> float:
        return sum(self.time_s.values())

    def gco2_total(self) -> float:
        return sum(self.gco2_g.values())

    def by_family(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for cat, v in self.time_s.items():
            fam = _family(cat)
            out[fam] = out.get(fam, 0.0) + v
        return out

    def residues(self) -> Dict[str, float]:
        """Unattributed residue, absolute and as a horizon fraction."""
        horizon = self.horizon_s if self.horizon_s is not None \
            else self.time_total()
        time_res = horizon - self.time_total()
        g_total = self.gco2_total_g if self.gco2_total_g is not None \
            else self.gco2_total()
        g_res = g_total - self.gco2_total()
        return {
            "time_residue_s": time_res,
            "time_residue_frac":
                abs(time_res) / horizon if horizon else 0.0,
            "gco2_residue_g": g_res,
            "gco2_residue_frac":
                abs(g_res) / g_total if g_total else 0.0,
        }

    def check(self) -> List[str]:
        """Conservation violations (empty list == ledger conserves)."""
        errors = []
        if self.horizon_s is None:
            errors.append("ledger not closed (no horizon)")
            return errors
        res = self.residues()
        if res["time_residue_frac"] > self.tolerance:
            errors.append(
                f"time residue {res['time_residue_s']:.6g}s is "
                f"{res['time_residue_frac']:.3%} of horizon "
                f"{self.horizon_s:.6g}s (> {self.tolerance:.2%}) — "
                "un- or double-billed clock charges")
        if self.gco2_total_g is not None and \
                res["gco2_residue_frac"] > self.tolerance:
            errors.append(
                f"gCO2 residue {res['gco2_residue_g']:.6g}g is "
                f"{res['gco2_residue_frac']:.3%} of total "
                f"{self.gco2_total_g:.6g}g (> {self.tolerance:.2%})")
        return errors

    def summary(self) -> dict:
        return {
            "time_s": dict(sorted(self.time_s.items())),
            "time_by_family_s": dict(sorted(self.by_family().items())),
            "gco2_g": dict(sorted(self.gco2_g.items())),
            "span_s": self.span_s,
            "horizon_s": self.horizon_s,
            "gco2_total_g": self.gco2_total_g,
            "embodied_g": self.embodied_g,
            "residues": self.residues(),
            "conserved": not self.check(),
            "tolerance": self.tolerance,
        }

    def export(self, path: str) -> None:
        """Write the attribution as a ``*.ledger.json`` artifact."""
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=1, sort_keys=True)
            f.write("\n")

    # -- trace streaming ----------------------------------------------
    def emit(self, recorder, t: float) -> None:
        """Stream cumulative per-category totals as ``ledger`` counter
        samples at modeled time ``t`` (cheap; call once per scheduler
        iteration and once at close)."""
        if self.time_s:
            recorder.counter("ledger", "time_s", t, **self.time_s)
        if self.gco2_g:
            recorder.counter("ledger", "gco2_g", t, **self.gco2_g)
        totals = {}
        if self.span_s is not None:
            totals["span_s"] = self.span_s
        if self.horizon_s is not None:
            totals["horizon_s"] = self.horizon_s
        if self.gco2_total_g is not None:
            totals["gco2_total_g"] = self.gco2_total_g
        if totals:
            recorder.counter("ledger", "totals", t, **totals)


def reconstruct(events, *, tolerance: float = DEFAULT_TOLERANCE
                ) -> TimeLedger:
    """Rebuild a :class:`TimeLedger` from normalized trace events (see
    :func:`repro_torch.obs.profile.events_from_chrome`): the last cumulative
    ``ledger`` counter sample per series wins, so a ring-truncated trace
    still reconstructs exactly."""
    led = TimeLedger(tolerance=tolerance)
    last: Dict[str, dict] = {}
    for ev in events:
        if ev["kind"] == "counter" and ev["track"] == "ledger":
            last[ev["name"]] = ev["args"]
    for cat, v in last.get("time_s", {}).items():
        led.bill(cat, float(v))
    for cat, v in last.get("gco2_g", {}).items():
        led.bill_g(cat, float(v))
    totals = last.get("totals", {})
    if "span_s" in totals:
        led.close(span_s=float(totals["span_s"]),
                  horizon_s=float(totals.get("horizon_s",
                                             totals["span_s"])),
                  gco2_total_g=(float(totals["gco2_total_g"])
                                if "gco2_total_g" in totals else None))
    return led
