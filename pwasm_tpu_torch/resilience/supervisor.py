"""Supervised execution of device batches.

Counterpart of ``pwasm_tpu/resilience/supervisor.py``, without its
degradations.  Every device round-trip of a run (the ctx_scan report
batches, the ``--realign`` dispatches, the consensus launch, the clip
refinement, the many2many scorer) goes through
:meth:`BatchSupervisor.run`, which adds:

- bounded **retry** with exponential backoff and jitter: a transient
  device fault re-executes on the same device instead of ending the
  run;
- a per-attempt **deadline** (``--device-deadline``): the attempt runs
  in a daemon thread that is abandoned at the deadline, the only
  portable way to walk away from a hung call;
- **guardrail validation** (``guardrails.py``): out-of-domain output
  counts as a device fault and is re-executed, never formatted;
- **circuit breakers** with per-site failure windows: after N
  consecutive failures at one site (``ctx_scan``, ``realign``,
  ``consensus``, ``refine``, ``many2many``; thresholds per site through
  ``ResiliencePolicy.site_thresholds``) one bounded CUDA probe
  (``utils/backend.py``) tells a dead card from a bad batch.  An
  unreachable probe opens the breaker globally; a healthy one
  half-opens the site, and a site that keeps exhausting its window
  (``site_trip_limit`` half-opens) trips its own breaker;
- **OOM-aware bisection**: a device allocation failure (classified by
  :func:`is_oom_error`) is not retried at the same shape and charges no
  breaker.  A site that declares a :class:`BisectableBatch` gets its
  batch split in half recursively (each half supervised in full), and
  the run's pow2 batch ceiling is demoted (``bucket_ceiling``, carried
  in the checkpoint) so later flushes pre-chunk, then re-promoted after
  ``repromote_after`` clean flushes.

The port's only policy is the reference's ``--fallback=fail``: when
retries, a breaker or a bisection run out, :class:`ResilienceError`
(exit 1) aborts the run, whose last checkpoint stays valid.  Moving
device work to the host (``--fallback=cpu``) and re-promoting it after
such a move (``resilience/health.py``, ``--recover``) are degradations
the port does not have.  Every decision increments a counter on the
run's ``RunStats`` (the ``--stats`` ``resilience`` block) and, where the
reference emits one, an ``obs`` event.
"""

from __future__ import annotations

import os
import random
import sys
import threading
import time
from dataclasses import dataclass, replace
from typing import NoReturn

from pwasm_tpu_torch.core.errors import PwasmError
from pwasm_tpu_torch.obs import NULL_OBS
from pwasm_tpu_torch.resilience.faults import (FaultPlan, InjectedFault,
                                               InjectedOOM, InjectedOutage)
from pwasm_tpu_torch.resilience.guardrails import GuardrailViolation

# substrings that mark a device ALLOCATION failure, lower-cased: the
# reference's markers; torch.cuda.OutOfMemoryError ("CUDA out of
# memory") and a launcher's cudaErrorMemoryAllocation ("out of memory",
# ops/banded_dp.py::check_launch) carry the second.  Classification is
# textual, so the injected InjectedOOM proves the live classifier
_OOM_MARKERS = ("resource_exhausted", "out of memory",
                "failed to allocate")


def is_oom_error(e: BaseException | None) -> bool:
    """True when ``e`` is a device allocation failure: retrying the
    same shape is pointless and the card is healthy, so the supervisor
    bisects instead of retrying or charging a breaker."""
    if e is None:
        return False
    s = f"{type(e).__name__}: {e}".lower()
    return any(m in s for m in _OOM_MARKERS)


class DeadlineExceeded(Exception):
    """A supervised attempt outlived the per-batch deadline."""


class ResilienceError(PwasmError):
    """Fatal (exit 1): device work failed after the bounded retries,
    and the port never degrades it to the host."""


@dataclass
class BisectableBatch:
    """How a supervised site lets the supervisor SPLIT its batch after
    a device allocation failure: the ordered items the attempt covers,
    a factory of a fresh attempt over any sub-list, a per-part
    validator, and the combiner that reassembles the parts' results in
    item order.  Each part runs through ``BatchSupervisor.run`` itself,
    so it keeps retries, the deadline, guardrails and injection."""

    items: list                 # the batch, in result order
    attempt_for: object         # (items) -> result (launch + fetch)
    combine: object             # (list[(items, result)]) -> result
    validate_for: object = None  # (result, items) -> None, may raise
    #                              GuardrailViolation
    floor: int = 1              # never split below this many items


@dataclass
class ResiliencePolicy:
    max_retries: int = 2          # extra attempts after the first
    backoff_s: float = 0.05       # first retry delay
    backoff_cap_s: float = 2.0    # ceiling for the exponential delay
    jitter: float = 0.5           # +[0, jitter) fraction of the delay
    deadline_s: float | None = None  # per-attempt wall ceiling
    fallback: str = "fail"        # the only policy: abort, never degrade
    breaker_threshold: int = 5    # consecutive failures (per site) to
    #                               suspect the card and probe it
    site_thresholds: dict | None = None  # per-site overrides of
    #                               breaker_threshold
    site_trip_limit: int = 3      # healthy-probe half-opens before a
    #                               site's own breaker trips
    repromote_after: int = 8      # consecutive clean sized flushes at a
    #                               demoted bucket_ceiling before it
    #                               probation-raises one pow2 step
    #                               (0 disables re-promotion)

    def __post_init__(self) -> None:
        if self.fallback != "fail":
            raise ValueError(f"fallback={self.fallback!r}: the port has "
                             "only the 'fail' policy (no host fallback)")

    def threshold_for(self, site: str) -> int:
        if self.site_thresholds:
            return int(self.site_thresholds.get(
                site, self.breaker_threshold))
        return self.breaker_threshold


class BatchSupervisor:
    """One per run, shared by every supervised site.  Failure windows
    are per site; the breaker a dead card opens (confirmed by the
    probe) is global.  ``stats`` is the run's ``RunStats`` (or None),
    ``faults`` a ``FaultPlan`` that arms injection, ``probe`` a
    replacement of the breaker's card check (tests), ``obs`` the run's
    observability bundle."""

    def __init__(self, policy: ResiliencePolicy | None = None,
                 stats=None, stderr=None, faults: FaultPlan | None = None,
                 probe=None, obs=None):
        self.policy = policy or ResiliencePolicy()
        self.stats = stats
        self.stderr = stderr if stderr is not None else sys.stderr
        self.obs = obs if obs is not None else NULL_OBS
        self.faults = faults
        self._probe = probe
        self._consecutive: dict[str, int] = {}  # site -> failure window
        self._half_opens: dict[str, int] = {}   # site -> half-opens
        self._site_open: set[str] = set()       # per-site open breakers
        self.breaker_open = False               # global (card dead)
        self.recloses = 0                       # restored from a
        #          reference checkpoint; the port never recloses
        self._degraded_t0: float | None = None  # breaker-open wall start
        self.bucket_ceiling: int | None = None  # pow2 batch ceiling a
        #          device OOM demoted: sites that declare a
        #          BisectableBatch pre-chunk to it (carried in the ckpt)
        self._ceiling_clean = 0                 # clean sized flushes
        #          since the last OOM or re-promotion
        self._ceiling_origin: int | None = None  # the largest bucket an
        #          OOM demoted from: climbing back to it restores None
        self._in_bisect = 0                     # bisection depth: halves
        #          do not count toward the ceiling's probation
        # jitter de-synchronizes the retries of many processes, so it is
        # seeded per process; it perturbs sleep times only
        self._rng = random.Random(os.getpid() ^ int(time.time() * 1e3))

    # ---- counters ------------------------------------------------------
    def _count(self, name: str, n: int = 1) -> None:
        if self.stats is not None and hasattr(self.stats, name):
            setattr(self.stats, name, getattr(self.stats, name) + n)

    def _warn(self, msg: str) -> None:
        print(f"pwasm: {msg}", file=self.stderr)

    # ---- the supervised call -------------------------------------------
    def run(self, site: str, attempt, validate=None,
            bisect: BisectableBatch | None = None,
            size: int | None = None):
        """Execute ``attempt()`` under the policy and return its
        validated result.

        ``attempt`` must be functional: it returns fresh host arrays
        and writes into no shared tensor, because an attempt abandoned
        at its deadline runs on in its thread.  ``validate(result)``
        raises ``GuardrailViolation`` to reject output; a rejection
        counts as a device fault and re-executes.  When the retries or
        a breaker run out, :class:`ResilienceError` aborts the run.

        ``bisect`` (a :class:`BisectableBatch`) makes the attempt
        OOM-recoverable: an allocation failure is not retried at the
        same shape and charges no breaker; the batch is bisected
        (down to ``bisect.floor``) and the pow2 ceiling demoted.
        ``size`` is the attempt's item count for the ``oom=`` fault
        (``len(bisect.items)`` by default)."""
        if size is None and bisect is not None:
            size = len(bisect.items)
        if self.faults is not None:
            # the scripted-outage clock ticks once a supervised call
            self.faults.note_call()
        if self.breaker_open:
            # only a --resume from a checkpoint whose breaker is open
            # gets here: the card was found dead and nothing re-probes
            self._count("res_degraded_batches")
            if self.faults is not None:
                self.faults.note_skipped(site)  # may InjectedKill
            self._degrade(site, "circuit breaker open", None)
        if site in self._site_open:
            self._degrade(site, f"site breaker open ({site})", None)
        delay = self.policy.backoff_s
        last: BaseException | None = None
        for k in range(self.policy.max_retries + 1):
            if k:
                self._count("res_retries")
                time.sleep(min(delay * (1 + self.policy.jitter
                                        * self._rng.random()),
                               self.policy.backoff_cap_s))
                delay *= 2
            # every attempt lands ONE wall observation, at its own
            # boundary (not in a finally: the OOM path runs the halves
            # before this attempt unwinds)
            t_att = time.perf_counter()

            def _attempt_wall(_t0=t_att) -> None:
                wall = time.perf_counter() - _t0
                self.obs.observe("batch_attempt_seconds", wall,
                                 site=site)
                if self.stats is not None:
                    # a site's first attempt is the compile-inclusive one
                    self.stats.note_attempt_wall(site, wall)

            try:
                if self.stats is not None:
                    # every supervised attempt is one device round-trip:
                    # the launch and the host-blocking fetch it ends in
                    self.stats.note_dispatch(site)
                    self.stats.note_flush()
                with self.obs.span("device_batch", site=site,
                                   attempt=k, items=size):
                    result = self._attempt_once(site, attempt, size)
                    if validate is not None:
                        validate(result)
                _attempt_wall()
                self._consecutive[site] = 0
                self._note_clean_flush(site, size)
                return result
            except GuardrailViolation as e:
                _attempt_wall()
                self._count("res_guardrail_rejects")
                self._warn(f"{site}: device output rejected by "
                           f"guardrail ({e}); re-executing")
                last = e
            except DeadlineExceeded as e:
                _attempt_wall()
                self._count("res_deadline_timeouts")
                last = e
            except Exception as e:
                _attempt_wall()
                if is_oom_error(e):
                    # an allocation failure: the same shape fails again
                    # and the card is healthy, so bisect, outside the
                    # retry loop and the breaker's window
                    return self._handle_oom(site, e, bisect)
                last = e
            if self._note_failure(site, last):
                break   # a breaker opened: stop burning retries
        self._degrade(site, _detail(last), last)

    # ---- OOM: bisect, never trip ---------------------------------------
    def _handle_oom(self, site: str, err: BaseException,
                    bisect: BisectableBatch | None):
        """A device allocation failure: count it, demote the batch
        ceiling and bisect where the site declared how.  The breaker is
        never charged; the run aborts only when no smaller split can
        succeed."""
        self._count("res_oom_events")
        self.obs.event("oom", site=site, detail=_detail(err),
                       items=len(bisect.items) if bisect else None)
        self._ceiling_clean = 0   # an OOM restarts the probation
        if bisect is not None and len(bisect.items) > max(1, bisect.floor):
            self._demote_bucket(site, len(bisect.items))
            try:
                return self._bisect(site, bisect)
            except ResilienceError:
                raise
            except Exception as e2:
                # the recombine failed: the whole batch fails here
                self._degrade(site, _detail(e2), e2)
        self._warn(f"{site}: device allocation failed "
                   f"({_detail(err)}) and the batch cannot be split "
                   "further; degrading")
        self._degrade(site, _detail(err), err)

    def _bisect(self, site: str, spec: BisectableBatch):
        """Split ``spec.items`` in half, run each half through the full
        supervised path (recursively bisecting on a further OOM), and
        recombine in item order."""
        items = spec.items
        mid = (len(items) + 1) // 2
        self._count("res_batch_splits")
        self.obs.event("batch_split", site=site, items=len(items),
                       halves=[mid, len(items) - mid])
        self._warn(f"{site}: bisecting {len(items)}-item batch into "
                   f"{mid}+{len(items) - mid} after device OOM")
        parts = []
        self._in_bisect += 1
        try:
            for sub in (items[:mid], items[mid:]):
                if not sub:
                    continue
                sub_spec = replace(spec, items=sub)
                validate = None
                if spec.validate_for is not None:
                    validate = (lambda r, _s=sub:
                                spec.validate_for(r, _s))
                r = self.run(
                    site,
                    (lambda _s=sub_spec: _s.attempt_for(_s.items)),
                    validate=validate,
                    bisect=sub_spec if len(sub) > max(1, spec.floor)
                    else None,
                    size=len(sub))
                parts.append((sub, r))
        finally:
            self._in_bisect -= 1
        return spec.combine(parts)

    def _demote_bucket(self, site: str, failed_size: int) -> None:
        """An attempt over ``failed_size`` items OOMed: the new ceiling
        is half its pow2 bucket; only an actual lowering counts."""
        bucket = 1 << max(0, int(failed_size) - 1).bit_length()
        if self._ceiling_origin is None or bucket > self._ceiling_origin:
            self._ceiling_origin = bucket
        new = max(1, bucket // 2)
        if self.bucket_ceiling is None or new < self.bucket_ceiling:
            self.bucket_ceiling = new
            self._count("res_bucket_demotions")
            self.obs.event("bucket_demotion", site=site, ceiling=new,
                           failed_size=int(failed_size))
            self._warn(f"{site}: batch bucket ceiling demoted to "
                       f"{new} items for the rest of the run "
                       f"(device OOM at {failed_size})")

    def _note_clean_flush(self, site: str, size: int | None) -> None:
        """One sized attempt succeeded while the ceiling is demoted:
        after ``policy.repromote_after`` consecutive clean flushes that
        fill the current bucket (bisection halves excluded) the ceiling
        rises one pow2 step, and climbing back to the bucket that
        failed restores it to None; a new OOM re-demotes it."""
        if (self.bucket_ceiling is None or size is None
                or self._in_bisect or self.policy.repromote_after <= 0
                or size * 2 <= self.bucket_ceiling):
            return
        self._ceiling_clean += 1
        if self._ceiling_clean < self.policy.repromote_after:
            return
        old = self.bucket_ceiling
        new = old * 2
        self._ceiling_clean = 0
        self._count("res_bucket_repromotions")
        if self._ceiling_origin is not None \
                and new >= self._ceiling_origin:
            self.bucket_ceiling = None
            self.obs.event("bucket_repromotion", site=site,
                           ceiling=None, restored=True)
            self._warn(f"{site}: batch bucket ceiling RESTORED "
                       f"(probation passed back to the {old}-item "
                       "bucket; an OOM re-demotes it)")
            return
        self.bucket_ceiling = new
        self.obs.event("bucket_repromotion", site=site, ceiling=new,
                       restored=False)
        self._warn(f"{site}: batch bucket ceiling probation-raised "
                   f"{old} -> {new} items after "
                   f"{self.policy.repromote_after} consecutive clean "
                   "flushes (an OOM re-demotes it)")

    def _attempt_once(self, site: str, attempt, size: int | None = None):
        plan = self.faults

        def body():
            if plan is None:
                return attempt()
            kind = plan.draw(site)       # may raise InjectedKill
            if kind == "down":
                self._count("res_injected_faults")
                raise InjectedOutage(
                    f"injected backend outage at {site} (tunnel down — "
                    "scripted down= window)")
            if plan.oom_for(size):
                # the simulated memory ceiling fails before any compute
                # and dominates a drawn compute-stage kind (not counted)
                self._count("res_injected_faults")
                raise InjectedOOM(
                    f"injected RESOURCE_EXHAUSTED at {site}: batch of "
                    f"{size} items exceeds the simulated device memory "
                    f"ceiling ({plan.oom})")
            if kind is not None:
                self._count("res_injected_faults")
            if kind == "raise":
                raise InjectedFault(f"injected device fault at {site}")
            if kind == "hang":
                time.sleep(plan.effective_hang(self.policy.deadline_s))
            res = attempt()
            if kind in ("nan", "corrupt"):
                res = plan.corrupt(res, site, kind)
            return res

        deadline = self.policy.deadline_s
        if deadline is None:
            return body()
        # a daemon thread, not a pool worker (those are joined at exit,
        # so a hung call would still block the interpreter's exit).  A
        # fresh thread starts on the CUDA default stream and device 0:
        # every launcher enters its tensors' device itself
        box: dict = {}

        def runner():
            try:
                box["ok"] = body()
            except BaseException as e:
                box["err"] = e

        t = threading.Thread(target=runner, daemon=True,
                             name=f"pwasm-{site}")
        t.start()
        t.join(deadline)
        if t.is_alive():
            raise DeadlineExceeded(
                f"{site}: batch exceeded the {deadline:g}s device "
                f"deadline") from None
        if "err" in box:
            raise box["err"]
        return box["ok"]

    # ---- failure accounting / breaker ----------------------------------
    def consecutive(self, site: str) -> int:
        """This site's current consecutive-failure window."""
        return self._consecutive.get(site, 0)

    def site_breaker_open(self, site: str) -> bool:
        return site in self._site_open

    def _note_failure(self, site: str, err: BaseException) -> bool:
        """Record one failed attempt at ``site``; True when a breaker
        (global or this site's) just opened (stop retrying)."""
        self._consecutive[site] = self.consecutive(site) + 1
        threshold = self.policy.threshold_for(site)
        if self.breaker_open or self.consecutive(site) < threshold:
            return False
        ok, why = self._probe_backend()
        if ok:
            # the card answers: the failures are the batch's or the
            # program's, so half-open THIS site; after site_trip_limit
            # half-opens its own breaker trips (counted apart from the
            # dead-card trip operators page on)
            self._consecutive[site] = 0
            self._half_opens[site] = self._half_opens.get(site, 0) + 1
            if self._half_opens[site] >= self.policy.site_trip_limit:
                self._site_open.add(site)
                self._count("res_site_breaker_trips")
                self.obs.event("site_breaker_trip", site=site,
                               half_opens=self._half_opens[site])
                self._warn(
                    f"{site}: {self._consecutive_msg(site)} for the "
                    f"{self._half_opens[site]}th time with a healthy "
                    "backend — SITE breaker OPEN, degrading this "
                    "site's device work to the host path for the rest "
                    "of the run")
                return True
            self.obs.event("site_breaker_half_open", site=site,
                           half_opens=self._half_opens[site])
            self._warn(f"{site}: {self._consecutive_msg(site)} but the "
                       "backend probes healthy; breaker half-open")
            return False
        self._open_breaker()
        self._count("res_breaker_trips")
        self.obs.event("breaker_trip", site=site,
                       why=(why or "unreachable").strip())
        self._warn(f"{site}: {self._consecutive_msg(site)}; backend "
                   f"probe says: {why.strip() or 'unreachable'} — "
                   "circuit breaker OPEN, degrading device work to the "
                   "host path for the rest of the run")
        return True

    def _open_breaker(self) -> None:
        self.breaker_open = True
        if self._degraded_t0 is None:
            self._degraded_t0 = time.perf_counter()
        # a card just found dead invalidates any cached healthy probe
        # verdict: the next process must probe, not hang on its context
        from pwasm_tpu_torch.utils.backend import invalidate_probe_cache
        invalidate_probe_cache()

    def finalize_stats(self) -> None:
        """End-of-run accounting: a run that ends with the breaker open
        owes its open window to ``degraded_wall_s``."""
        if self._degraded_t0 is not None:
            self._count("res_degraded_wall_s",
                        time.perf_counter() - self._degraded_t0)
            self._degraded_t0 = None

    # ---- checkpointed state --------------------------------------------
    def export_state(self) -> dict:
        """Breaker, ceiling and fault-clock state for the checkpoint's
        ``resilience`` key (the reference's keys), written after every
        completed batch so a ``--resume`` inherits it."""
        st = {
            "breaker_open": self.breaker_open,
            "recloses": self.recloses,
            "site_open": sorted(self._site_open),
            "half_opens": dict(self._half_opens),
            "consecutive": {k: v for k, v in self._consecutive.items()
                            if v},
            "bucket_ceiling": self.bucket_ceiling,
            "bucket_clean_flushes": self._ceiling_clean,
            "bucket_demoted_from": self._ceiling_origin,
        }
        if self.faults is not None:
            st["fault_calls"] = self.faults._calls
        return st

    def restore_state(self, st: dict) -> None:
        """Inherit checkpointed state on ``--resume`` (the inverse of
        :meth:`export_state`).  Each field restores on its own: a
        malformed one drops only itself."""
        def field(restore):
            try:
                restore()
            except (TypeError, ValueError, AttributeError, KeyError):
                pass

        if st.get("breaker_open"):
            field(self._open_breaker)
        field(lambda: setattr(
            self, "recloses", int(st.get("recloses", 0) or 0)))
        field(lambda: setattr(
            self, "_site_open",
            {str(s) for s in st.get("site_open", [])}))
        field(lambda: setattr(
            self, "_half_opens",
            {str(k): int(v) for k, v
             in dict(st.get("half_opens", {})).items()}))
        field(lambda: setattr(
            self, "_consecutive",
            {str(k): int(v) for k, v
             in dict(st.get("consecutive", {})).items()}))
        if st.get("bucket_ceiling") is not None:
            # a demoted ceiling is a fact about the card, not the killed
            # process: a --resume must not re-OOM its way down to it
            field(lambda: setattr(
                self, "bucket_ceiling",
                max(1, int(st["bucket_ceiling"]))))
        field(lambda: setattr(
            self, "_ceiling_clean",
            max(0, int(st.get("bucket_clean_flushes", 0) or 0))))
        if st.get("bucket_demoted_from") is not None:
            field(lambda: setattr(
                self, "_ceiling_origin",
                max(1, int(st["bucket_demoted_from"]))))
        if self.faults is not None and "fault_calls" in st:
            field(lambda: setattr(
                self.faults, "_calls", int(st["fault_calls"])))

    def _consecutive_msg(self, site: str) -> str:
        return (f"{self.policy.threshold_for(site)} consecutive device "
                "failures")

    def _probe_backend(self) -> tuple[bool, str]:
        if self.faults is not None:
            # a scripted outage window dominates every other verdict
            why = self.faults.outage_probe()
            if why is not None:
                return False, why
        if self._probe is not None:
            return self._probe()
        # a REAL bounded subprocess probe, never the cached startup
        # gate: by the time a batch fails this process holds a context,
        # and a cached "healthy" would hide a card that just died
        if os.environ.get("PWASM_DEVICE_PROBE", "1") == "0":
            return True, ""    # probing disabled: healthy (half-open)
        from pwasm_tpu_torch.utils.backend import (probe_backend,
                                                   probe_timeout)
        platform, why = probe_backend(dict(os.environ), probe_timeout())
        return platform is not None, why

    # ---- the one policy ------------------------------------------------
    def _degrade(self, site: str, reason: str,
                 err: BaseException | None) -> NoReturn:
        """Give up on ``site``'s device work: the port never moves it
        to the host, so the run aborts."""
        raise ResilienceError(
            f"Error: device work '{site}' failed and --fallback="
            f"fail forbids degrading ({reason})\n") from err


def _detail(e: BaseException | None) -> str:
    """``TypeName: message`` on one line, at most 200 characters of
    message (the reference's ``utils.exc_detail``)."""
    if e is None:
        return "no attempt made"
    return f"{type(e).__name__}: " + str(e).replace("\n", " ")[:200]
