"""Sequential drift watchdog over the serving audit stream, a copy of
``repro.serving.watchdog`` (host arithmetic in both packages).

QWYC's thresholds are calibrated offline to keep the disagreement rate
vs the FULL ensemble at ``alpha``.  That contract silently breaks when
the serving distribution drifts: early exits keep firing, but they stop
agreeing with what the full cascade would have said.  The server's audit
path already computes exactly the needed signal — per-flush counts of
``decision != full_decision`` — so the watchdog is a consumer of that
stream, not a new scoring pass.

The statistic is the classic one-sided sequential likelihood ratio (a
CUSUM, the repeated-SPRT view of Kalman & Moscovich's sequential
testing): after a flush with ``n`` audited rows and ``k`` disagreements,

    llr += k * log(p1/p0) + (n - k) * log((1-p1)/(1-p0));   llr = max(llr, 0)

where ``p0`` is the calibrated disagreement rate (the fitted ``alpha``,
floored away from zero) and ``p1`` the drifted alternative.  Clamping at
zero restarts the test whenever the evidence favors ``p0``, so detection
latency is independent of how long the healthy stretch before the drift
lasted.  ``llr >= alarm`` trips the alarm.

On alarm the server *degrades the decide policy* instead of serving
miscalibrated exits: each alarmed flush applies the next margin from
``margin_schedule`` — thresholds widen to ``eps_pos + m`` / ``eps_neg -
m``, monotonically fewer early exits — with the default single-step
schedule ``(inf,)`` forcing full-cascade evaluation outright.  Under a
widened plan disagreements drop (at ``inf`` they are structurally zero),
the statistic decays below ``reset``, and the watchdog re-arms the
calibrated thresholds: state ``alarmed -> recovering -> ok`` with the
flush index of the recovery recorded for the chaos benchmarks'
recovery-latency metric.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.executor import CascadePlan

__all__ = ["WatchdogConfig", "DriftWatchdog", "widen_plan"]


def widen_plan(plan: CascadePlan, margin: float) -> CascadePlan:
    """The degraded decide policy: widen both exit thresholds by
    ``margin`` (``inf`` = no early exits, i.e. full-cascade evaluation).
    Widening only ever *removes* exits, so a degraded verdict equals the
    full-ensemble verdict for any row the calibrated plan would have
    exited wrongly."""
    if margin == 0.0:
        return plan
    return dataclasses.replace(
        plan,
        eps_pos=plan.eps_pos + margin,
        eps_neg=plan.eps_neg - margin,
    )


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """Alarm geometry for ``DriftWatchdog``.

    ``p0``: calibrated (null) disagreement rate — pass the fitted
    ``alpha``; floored at ``p_floor`` so a zero-alpha fit still yields a
    finite test.  ``p1``: drifted alternative; default
    ``max(5 * p0, p0 + 0.05)``.  ``alarm``: llr trip level (4.0 ~ an
    ~e^4 : 1 likelihood ratio, the usual CUSUM h).  ``reset``: llr level
    at which an alarmed watchdog re-arms the calibrated thresholds.
    ``margin_schedule``: per-alarmed-flush threshold widening; the last
    entry repeats while the alarm persists (default: jump straight to
    full-cascade evaluation).
    """

    p0: float = 0.01
    p1: float | None = None
    alarm: float = 4.0
    reset: float = 0.5
    margin_schedule: tuple = (math.inf,)
    p_floor: float = 1e-3

    def __post_init__(self):
        if not self.margin_schedule:
            raise ValueError("margin_schedule must have at least one margin")
        if any(m < 0 for m in self.margin_schedule):
            raise ValueError("margins must be >= 0")
        if self.alarm <= 0 or self.reset < 0 or self.reset >= self.alarm:
            raise ValueError("need 0 <= reset < alarm, alarm > 0")

    def rates(self) -> tuple[float, float]:
        p0 = min(max(self.p0, self.p_floor), 0.5)
        p1 = max(5 * p0, p0 + 0.05) if self.p1 is None else self.p1
        p1 = min(max(p1, p0 * 1.5), 0.999)
        return p0, p1


class DriftWatchdog:
    """One-sided sequential test + degradation controller.

    ``observe(n, diffs)`` consumes one audited flush and returns the
    threshold margin the NEXT flush must apply (0.0 while healthy).
    States: ``ok`` (calibrated thresholds), ``alarmed`` (llr crossed
    ``alarm``; margins active), ``recovering`` (margins active, llr
    fell back under ``reset``; one clean flush re-arms), then ``ok``.
    """

    def __init__(self, config: WatchdogConfig | None = None):
        self.config = config or WatchdogConfig()
        p0, p1 = self.config.rates()
        self._w_diff = math.log(p1 / p0)
        self._w_same = math.log((1.0 - p1) / (1.0 - p0))
        self.llr = 0.0
        self.state = "ok"
        self.alarms = 0
        self.flushes = 0
        self.alarm_step: int | None = None
        self.recovery_step: int | None = None
        self._level = 0  # index into margin_schedule while alarmed

    @property
    def margin(self) -> float:
        if self.state == "ok":
            return 0.0
        sched = self.config.margin_schedule
        return float(sched[min(self._level, len(sched) - 1)])

    def observe(self, n: int, diffs: int) -> float:
        """Fold one audited flush (``n`` rows, ``diffs`` disagreements)
        into the statistic; returns the margin for the next flush."""
        self.flushes += 1
        if n > 0:
            diffs = min(int(diffs), int(n))
            self.llr += diffs * self._w_diff + (int(n) - diffs) * self._w_same
            # clamp below at 0 (restart-on-favorable-evidence, the CUSUM
            # trick) and above at 2x the alarm level (bounded memory, so
            # recovery latency after a long drift burst is bounded too)
            self.llr = min(max(self.llr, 0.0), 2.0 * self.config.alarm)
        if self.state == "ok":
            if self.llr >= self.config.alarm:
                self.state = "alarmed"
                self.alarms += 1
                self.alarm_step = self.flushes
                self._level = 0
        elif self.state == "alarmed":
            if self.llr <= self.config.reset:
                self.state = "recovering"
            else:
                self._level += 1  # escalate along the margin schedule
        else:  # recovering: this flush ran widened and stayed clean
            if self.llr <= self.config.reset:
                self.state = "ok"
                self.recovery_step = self.flushes
                self._level = 0
            else:
                self.state = "alarmed"
        return self.margin
