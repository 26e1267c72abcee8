"""Deterministic fault injection for the device pipeline.

Counterpart of ``pwasm_tpu/resilience/faults.py``, copied whole: the
same spec, the same draws and the same corruption, so one spec gives
the same fault sequence in both packages.  Every supervised device call site (``resilience.supervisor``) consults
the armed :class:`FaultPlan` before and after the real work.  Draws are
seeded and keyed on ``(seed, site, per-site attempt counter)``, so a
given spec produces the identical fault sequence on every run — the
property the byte-parity acceptance test rests on — and retries of the
same batch advance the counter, so a fault-free draw eventually lets
the batch through.

Spec format (``--inject-faults=SPEC`` / ``PWASM_INJECT_FAULTS``), a
comma-separated ``key=value`` list:

  ``seed=N``      RNG seed (default 0)
  ``rate=P``      per-attempt fault probability in [0, 1] (default 0)
  ``kinds=a+b``   fault mix, ``+``-separated from {raise, hang, nan,
                  corrupt} (default all four), drawn uniformly
  ``sites=x+y``   restrict injection to these site names (default all;
                  site names: ``ctx_scan``, ``realign``, ``consensus``,
                  ``many2many``, ``refine``)
  ``hang_s=S``    simulated hang duration in seconds (default 30;
                  meant to exceed ``--device-deadline``).  NB the
                  supervisor caps the slept time at a small multiple of
                  the armed deadline (or ~1 s when no deadline is set),
                  so an injected hang proves the timeout machinery
                  without stalling a fast test suite — see
                  :meth:`FaultPlan.effective_hang`
  ``kill=K``      raise an uncatchable :class:`InjectedKill` on the
                  K-th supervised attempt (counted across all sites,
                  and a batch skipped by an open global breaker counts
                  as one attempt) — simulates a mid-run process kill
                  for checkpoint / resume testing
  ``preempt=N``   request a GRACEFUL DRAIN (``resilience.lifecycle``)
                  at the N-th supervised call: the run finishes its
                  in-flight batch, flushes a final checkpoint and a
                  partial ``--stats``, and exits with the documented
                  preempted-resumable code (75) — the scripted twin of
                  a fleet scheduler's SIGTERM, deterministic for
                  drain/resume parity tests
  ``oom=N``       simulated device memory ceiling, in batch items: any
                  supervised attempt over a batch LARGER than N items
                  raises a ``RESOURCE_EXHAUSTED``-shaped
                  :class:`InjectedOOM` — deterministic by size, so the
                  supervisor's batch bisection provably converges (the
                  halves at or under N succeed)
  ``down=A-B``    scripted OUTAGE WINDOWS, ``+``-separated inclusive
                  1-based ranges over the global supervised-CALL
                  counter (one tick per ``BatchSupervisor.run``
                  invocation, degraded calls included): every device
                  attempt made while the counter is inside a window
                  fails with an outage-shaped :class:`InjectedOutage`,
                  and backend probes report unreachable — so tests can
                  script "device dies at batch A, returns after batch
                  B" and assert the breaker opens AND recloses

Example: ``--inject-faults=seed=7,rate=0.3,kinds=raise+nan+corrupt``;
a flap: ``--inject-faults=down=2-4``.

Fault kinds:

- ``raise``    the device call raises :class:`InjectedFault`;
- ``hang``     the call sleeps ``hang_s`` seconds first (a supervisor
               deadline turns that into ``DeadlineExceeded``);
- ``nan``      float outputs get NaNs written into a seeded slice
               (integer outputs get out-of-range garbage instead);
- ``corrupt``  one output array gets a seeded slice overwritten with
               out-of-domain values — the silent-corruption case the
               guardrails must catch.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass, field

import numpy as np

KINDS = ("raise", "hang", "nan", "corrupt")

# garbage written by corrupt/nan into integer arrays: far outside every
# guarded domain (codes, flags, positions, scores) but well inside
# int32, so the corruption is silent at the dtype level
_INT_GARBAGE = 0x3FFFFFF0


class InjectedFault(RuntimeError):
    """The exception a ``raise`` fault throws inside a device call."""


class InjectedOutage(InjectedFault):
    """The outage-shaped error a scripted ``down=A-B`` outage window
    throws for every device attempt inside the window — distinct from
    :class:`InjectedFault` so tests can tell a scripted backend outage
    from a random computational fault."""


class InjectedOOM(InjectedFault):
    """The ``RESOURCE_EXHAUSTED``-shaped error the ``oom=N`` leg throws
    for any supervised attempt whose batch exceeds the simulated memory
    ceiling.  The message deliberately carries the allocator's marker so
    the supervisor's OOM *classifier* (not an isinstance check) is what
    the injection exercises — the same code path a live chip's
    allocation failure takes."""


class InjectedKill(BaseException):
    """Simulated process kill (``kill=K``).  Derives from BaseException
    so no retry/fallback layer can swallow it — it unwinds the whole
    run exactly like SIGKILL would end it, leaving only what the
    batch checkpoints made durable.  Inside a warm ``serve`` process
    the blast radius is the JOB, not the daemon: the worker catches it
    at the job boundary and marks the job failed (its checkpointed
    prefix stays resumable), because a scripted kill must never take
    out the other tenants of a shared process."""


@dataclass
class FaultPlan:
    seed: int = 0
    rate: float = 0.0
    kinds: tuple[str, ...] = KINDS
    sites: frozenset[str] | None = None   # None = all sites
    hang_s: float = 30.0
    kill: int = 0                         # 0 = disabled; else 1-based
    preempt: int = 0                      # 0 = disabled; else 1-based
    #          supervised call at which a graceful drain is requested
    oom: int = 0                          # 0 = disabled; else the
    #          simulated device memory ceiling in batch items
    down: tuple[tuple[int, int], ...] = ()  # outage windows over _calls
    on_preempt: object = field(default=None, repr=False)  # drain hook:
    #          (reason: str) -> None, wired to SignalDrain.request by
    #          the CLI so preempt= drives the same flag a SIGTERM sets
    _site_counters: dict = field(default_factory=dict, repr=False)
    _attempts: int = field(default=0, repr=False)
    _calls: int = field(default=0, repr=False)  # supervised-call clock
    #          (one tick per BatchSupervisor.run invocation, degraded
    #          calls included) — the down= windows are scripted on it,
    #          and it is persisted in <report>.ckpt so a --resume lands
    #          back inside the same scripted window
    _preempted: bool = field(default=False, repr=False)

    def note_call(self) -> None:
        """Advance the supervised-call clock — called once at every
        ``BatchSupervisor.run`` entry, whether or not the device is
        attempted (an open breaker must not freeze a scripted outage
        window, or a flap could never end)."""
        self._calls += 1
        if self.preempt and not self._preempted \
                and self._calls >= self.preempt:
            # fires once; >= (not ==) so a --resume whose restored
            # clock already passed the mark still drains rather than
            # silently disarming the scripted preemption
            self._preempted = True
            if self.on_preempt is not None:
                self.on_preempt(f"injected preemption at supervised "
                                f"call {self._calls}")

    def oom_for(self, size: int | None) -> bool:
        """True when an attempt over ``size`` batch items must raise
        :class:`InjectedOOM` (deterministic by size — retrying the same
        shape can never succeed, which is the scenario the supervisor's
        bisection exists for)."""
        return bool(self.oom) and size is not None and size > self.oom

    def note_skipped(self, site: str) -> None:
        """A supervised call skipped by an open breaker still counts as
        one attempt toward ``kill=K`` — a kill scripted to land
        mid-outage must fire even though no device draw happens."""
        self._attempts += 1
        if self.kill and self._attempts >= self.kill:
            raise InjectedKill(
                f"injected kill at supervised attempt {self._attempts} "
                f"(site {site}, breaker open)")

    def in_outage(self) -> bool:
        """True while the supervised-call clock is inside a ``down=``
        window."""
        return any(a <= self._calls <= b for a, b in self.down)

    def outage_probe(self) -> str | None:
        """The scripted answer a backend probe must give: a diagnostic
        while inside an outage window, None outside (fall through to
        the real probe)."""
        if self.in_outage():
            return (f"injected outage (down window, supervised call "
                    f"{self._calls})")
        return None

    def effective_hang(self, deadline_s: float | None) -> float:
        """The capped sleep a ``hang`` fault actually performs: hangs
        exist to prove the deadline machinery, so sleeping much past
        the deadline (or for the full default 30 s when NO deadline is
        armed) only stalls the suite without proving anything more —
        cap at 4x the deadline, or ~1 s deadline-less."""
        cap = 4.0 * deadline_s if deadline_s else 1.0
        return min(self.hang_s, cap)

    def draw(self, site: str) -> str | None:
        """One deterministic fault draw for an attempt at ``site``.
        Returns a kind from :data:`KINDS` (or ``"down"`` inside a
        scripted outage window) or None, advancing the per-site counter
        either way.  Raises :class:`InjectedKill` when the global
        attempt counter reaches ``kill``."""
        self._attempts += 1
        if self.kill and self._attempts >= self.kill:
            raise InjectedKill(
                f"injected kill at supervised attempt {self._attempts} "
                f"(site {site})")
        k = self._site_counters.get(site, 0)
        self._site_counters[site] = k + 1
        if self.in_outage():
            # a dead backend fails every site, whatever sites= says —
            # and deterministically, whatever rate= says
            return "down"
        if self.sites is not None and site not in self.sites:
            return None
        rng = random.Random(f"{self.seed}|{site}|{k}")
        if rng.random() >= self.rate:
            return None
        return self.kinds[rng.randrange(len(self.kinds))]

    def corrupt(self, obj, site: str, kind: str):
        """Deterministically corrupt one numpy array inside ``obj``
        (dicts/tuples/lists walked recursively; everything else passes
        through untouched).  Returns a modified deep-ish copy — the
        original arrays are never written, so a retry that reuses a
        cached device result is not poisoned."""
        leaves: list[tuple] = []
        obj = _walk_copy(obj, leaves)
        if not leaves:
            return obj
        k = self._site_counters.get(site, 0)
        rng = random.Random(f"{self.seed}|corrupt|{site}|{k}")
        _, arr = leaves[rng.randrange(len(leaves))]
        flat = arr.reshape(-1)
        # corrupt a PREFIX slice: device batches are padded to compile
        # buckets, so a random offset would usually land in padding no
        # consumer ever reads — corruption that cannot be consequential
        # proves nothing about the guardrails
        n = max(1, flat.shape[0] // 8)
        start = 0
        if kind == "nan" and np.issubdtype(arr.dtype, np.floating):
            flat[start:start + n] = np.nan
        else:
            info = np.iinfo(arr.dtype) if np.issubdtype(
                arr.dtype, np.integer) else None
            val = _INT_GARBAGE if info is None or info.max >= _INT_GARBAGE \
                else info.max
            flat[start:start + n] = val
        return obj


def _walk_copy(obj, leaves: list):
    """Copy containers and ndarray leaves, collecting (path, array)
    pairs for the corruptible leaves (non-empty numeric/bool arrays)."""
    if isinstance(obj, dict):
        return {k: _walk_copy(v, leaves) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        out = [_walk_copy(v, leaves) for v in obj]
        return tuple(out) if isinstance(obj, tuple) else out
    if isinstance(obj, np.ndarray) and obj.size \
            and obj.dtype.kind in "iuf":
        # bool arrays are NOT corruption targets: a flipped flag is a
        # legal value no domain invariant can reject — the modeled
        # fault is out-of-domain garbage (bad DMA / stuck lanes), which
        # the guardrails are built to catch
        c = obj.copy()
        leaves.append((None, c))
        return c
    return obj


def parse_fault_spec(spec: str) -> FaultPlan:
    """Parse an ``--inject-faults`` spec string (see module docstring).
    Raises ValueError on malformed input."""
    plan = FaultPlan()
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(f"fault spec item without '=': {item!r}")
        key, val = item.split("=", 1)
        key = key.strip()
        val = val.strip()
        try:
            if key == "seed":
                plan.seed = int(val)
            elif key == "rate":
                plan.rate = float(val)
                if not 0.0 <= plan.rate <= 1.0:
                    raise ValueError
            elif key == "kinds":
                kinds = tuple(k for k in val.split("+") if k)
                bad = [k for k in kinds if k not in KINDS]
                if bad or not kinds:
                    raise ValueError
                plan.kinds = kinds
            elif key == "sites":
                plan.sites = frozenset(s for s in val.split("+") if s)
            elif key == "hang_s":
                plan.hang_s = float(val)
                if plan.hang_s < 0:
                    raise ValueError
            elif key == "kill":
                plan.kill = int(val)
                if plan.kill < 0:
                    raise ValueError
            elif key == "preempt":
                plan.preempt = int(val)
                if plan.preempt < 0:
                    raise ValueError
            elif key == "oom":
                plan.oom = int(val)
                if plan.oom < 0:
                    raise ValueError
            elif key == "down":
                wins = []
                for rng_s in val.split("+"):
                    a_s, _, b_s = rng_s.partition("-")
                    a, b = int(a_s), int(b_s)
                    if a < 1 or b < a:
                        raise ValueError
                    wins.append((a, b))
                if not wins:
                    raise ValueError
                plan.down = tuple(wins)
            else:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"bad fault spec item: {item!r} "
                f"(keys: seed rate kinds sites hang_s kill preempt "
                f"oom down)")
    return plan


def plan_from_env() -> FaultPlan | None:
    """The env-armed plan (``PWASM_INJECT_FAULTS``), for subprocesses
    that never see the CLI flag; None when unset/empty.  A malformed
    env spec raises — a debug knob that silently disarms would be worse
    than a crash."""
    spec = os.environ.get("PWASM_INJECT_FAULTS", "")
    return parse_fault_spec(spec) if spec else None
