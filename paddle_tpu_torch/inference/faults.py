"""Deterministic fault injection for the serving engine — port of
``paddle_tpu/inference/faults.py``.

A seeded :class:`FaultPlan` arms named failure seams in the serving
engine's hot paths and fires them from ONE ``numpy.random.RandomState``
stream, so a chaos run replays from its seed, and the same seed, rates
and hit sequence fire as the reference's plan does. The plan is scoped by
a context manager (``with FaultPlan(seed=7, dispatch=0.02): ...``); with
no plan armed each seam is one module-global ``None`` check.

Seams (the names ``ServingPredictor`` and ``KVCacheManager`` pass to
:func:`fault_point`):

- ``pool`` — pool-pressure squeeze: withholds ``squeeze_pages``
  strictly-free pages (``KVCacheManager.withhold_pages``) for
  ``squeeze_steps`` scheduler rounds. Hit at the top of every ``step()``,
  so a squeeze expires even while its pages are what blocks the next
  admission; the pages come back when it expires and at plan exit.
- ``h2d`` — raises :class:`InjectedFault` where the step's packed host
  arrays upload to the device (the pinned-staging ``Feed`` uploads).
- ``dispatch`` — raises :class:`InjectedFault` where the unified step
  would launch (before a geometry's first call runs and is captured).
- ``slow_step`` — sleeps ``slow_step_s`` before the launch (a straggler;
  exercises deadlines, never corrupts state).
- ``reconcile`` — raises :class:`InjectedFault` where an in-flight
  entry's emissions would land on the host (the async engine's wait).
- ``host_spill_drop`` — RETURNS ``True`` when it fires: the KV cache
  manager loses the spill (the page evicts without its payload reaching
  the host tier); the next admission recomputes.
- ``tier_restore_corrupt`` — RETURNS ``True`` when it fires: the manager
  flips a byte of the stored host-tier payload before its restore
  checksum runs, which must detect it (the entry drops, the lookup
  degrades to a recompute miss).
- ``replica_crash`` / ``replica_stall`` (the fleet router's) and
  ``transfer_drop`` / ``transfer_corrupt`` (the KV transfer wire's) draw
  and count here like the others; the port's fleet and transfer slices
  are the code that hits them.

Raising seams model crashes: they raise BEFORE the operation they name.
``plan.fired`` counts firings per seam; the predictor counts the injected
faults it observed on its registry (``serving_faults_injected{seam=}``).
"""
from __future__ import annotations

import time

import numpy as np

__all__ = ["FaultPlan", "InjectedFault", "SEAMS", "active_plan",
           "fault_point"]

#: the named seams a plan may arm (a typo'd rate kwarg fails at __init__)
SEAMS = ("pool", "h2d", "dispatch", "slow_step", "reconcile",
         "replica_crash", "replica_stall", "transfer_drop",
         "transfer_corrupt", "host_spill_drop", "tier_restore_corrupt")

#: the armed plan; None = disarmed (the zero-cost fast path)
_PLAN: "FaultPlan | None" = None


class InjectedFault(RuntimeError):
    """A deliberately-injected failure; carries its seam name so the
    recovery path can attribute it (``serving_faults_injected``)."""

    def __init__(self, seam: str):
        super().__init__(f"injected fault at seam '{seam}'")
        self.seam = seam


def active_plan() -> "FaultPlan | None":
    return _PLAN


def fault_point(seam: str, cache=None):
    """The seam hook the serving engine calls. Disarmed cost is this one
    module-global check (and the disarmed return is always ``None``).
    Raising seams raise :class:`InjectedFault`; the ``replica_stall``
    seam RETURNS its stall-tick count when it fires."""
    if _PLAN is not None:
        return _PLAN.hit(seam, cache=cache)
    return None


class FaultPlan:
    """One seeded chaos schedule over the named seams.

    ``dispatch`` / ``h2d`` / ``reconcile`` / ``slow_step`` /
    ``pool_squeeze`` are independent per-hit firing probabilities in
    ``[0, 1]``. All draws come from one ``RandomState(seed)`` in seam-hit
    order, so a deterministic scheduler replays the identical fault
    sequence. Not re-entrant (one armed plan per process) and not
    thread-aware — the serving engine drives every seam from the
    scheduler thread.
    """

    def __init__(self, seed: int = 0, *, dispatch: float = 0.0,
                 h2d: float = 0.0, reconcile: float = 0.0,
                 slow_step: float = 0.0, slow_step_s: float = 0.001,
                 pool_squeeze: float = 0.0, squeeze_pages: int = 2,
                 squeeze_steps: int = 2, replica_crash: float = 0.0,
                 replica_stall: float = 0.0, stall_ticks: int = 2,
                 transfer_drop: float = 0.0,
                 transfer_corrupt: float = 0.0,
                 host_spill_drop: float = 0.0,
                 tier_restore_corrupt: float = 0.0):
        rates = {"dispatch": dispatch, "h2d": h2d, "reconcile": reconcile,
                 "slow_step": slow_step, "pool": pool_squeeze,
                 "replica_crash": replica_crash,
                 "replica_stall": replica_stall,
                 "transfer_drop": transfer_drop,
                 "transfer_corrupt": transfer_corrupt,
                 "host_spill_drop": host_spill_drop,
                 "tier_restore_corrupt": tier_restore_corrupt}
        for name, p in rates.items():
            if not 0.0 <= float(p) <= 1.0:
                raise ValueError(f"{name} rate must be in [0, 1], got {p}")
        self.rates = {k: float(v) for k, v in rates.items()}
        self.rng = np.random.RandomState(seed)
        self.slow_step_s = float(slow_step_s)
        self.squeeze_pages = int(squeeze_pages)
        self.squeeze_steps = int(squeeze_steps)
        self.stall_ticks = int(stall_ticks)
        if self.stall_ticks < 1:
            raise ValueError(f"stall_ticks must be >= 1, got {stall_ticks}")
        self.fired: dict[str, int] = {s: 0 for s in SEAMS}
        # one active squeeze at a time: (cache, rounds_left)
        self._squeeze: tuple[object, int] | None = None

    # -- arming -------------------------------------------------------------

    def __enter__(self) -> "FaultPlan":
        global _PLAN
        if _PLAN is not None:
            raise RuntimeError("a FaultPlan is already armed")
        _PLAN = self
        return self

    def __exit__(self, *exc) -> bool:
        global _PLAN
        assert _PLAN is self
        _PLAN = None
        self._release_squeeze()
        return False

    def _release_squeeze(self) -> None:
        if self._squeeze is not None:
            cache, _ = self._squeeze
            cache.restore_withheld()
            self._squeeze = None

    # -- the seams ----------------------------------------------------------

    def hit(self, seam: str, cache=None) -> None:
        if seam == "pool":
            # expire a running squeeze first so pressure is bounded
            if self._squeeze is not None:
                cache_held, left = self._squeeze
                if left <= 1:
                    self._release_squeeze()
                else:
                    self._squeeze = (cache_held, left - 1)
            elif (cache is not None and self.rates["pool"]
                    and self.rng.rand() < self.rates["pool"]):
                if cache.withhold_pages(self.squeeze_pages):
                    self.fired["pool"] += 1
                    self._squeeze = (cache, self.squeeze_steps)
            return
        if seam == "slow_step":
            if self.rates["slow_step"] \
                    and self.rng.rand() < self.rates["slow_step"]:
                self.fired["slow_step"] += 1
                time.sleep(self.slow_step_s)
            return
        if seam == "replica_stall":
            # a RETURNING seam: the caller (the fleet router) applies
            # the stall — this plan only schedules it
            if self.rates["replica_stall"] \
                    and self.rng.rand() < self.rates["replica_stall"]:
                self.fired["replica_stall"] += 1
                return self.stall_ticks
            return None
        if seam in ("transfer_drop", "transfer_corrupt",
                    "host_spill_drop", "tier_restore_corrupt"):
            # RETURNING seams: the transfer layer applies the loss /
            # byte-flip to its own wire bytes (a corrupt frame must
            # reach the receiver so the checksum DETECTS it); the
            # round-21 host-tier seams work the same way on the cache
            # manager's spill/restore paths (a corrupt stored payload
            # must reach the restore checksum so it DETECTS it)
            if self.rates[seam] and self.rng.rand() < self.rates[seam]:
                self.fired[seam] += 1
                return True
            return None
        if seam not in self.rates:
            raise ValueError(f"unknown fault seam {seam!r} "
                             f"(known: {', '.join(SEAMS)})")
        if self.rates[seam] and self.rng.rand() < self.rates[seam]:
            self.fired[seam] += 1
            raise InjectedFault(seam)
