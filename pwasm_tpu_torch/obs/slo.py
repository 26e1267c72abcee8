"""Declarative SLO/alert rule engine over the live MetricsRegistry.

Counterpart of ``pwasm_tpu/obs/slo.py``, with its names, rule grammar,
transitions and verdicts.  It closes the self-monitoring loop: a small
set of declarative rules is evaluated on a timer over the same
:class:`~pwasm_tpu_torch.obs.metrics.MetricsRegistry` the exposition
serves, and firing/resolved transitions become event-log records,
metric families (``pwasm_alerts_firing{rule}`` /
``pwasm_alert_transitions_total{rule,state}``), and the machine-
readable **health verdict** the ``health`` protocol verb returns —
what orchestrator probes (k8s liveness, pagers) consume.

Three rule kinds, all plain dicts (JSON-loadable — ``serve
--slo-rules=FILE`` adds user rules to the defaults in
``obs/catalog.py``):

``threshold``
    compare a gauge/counter's current value (any labeled cell
    matches) against ``value`` via ``op``; optional ``divide_by``
    names a second metric whose summed value becomes the denominator
    (``queue_depth / max_queue > 0.8``); optional ``for_s`` requires
    the condition to hold continuously before firing (a one-scrape
    blip must not page).
``rate``
    the increase of a counter over the trailing ``window_s`` compared
    via ``op``/``value`` — "any journal replay in the last 5 minutes".
    ``baseline: "zero"`` counts the value at the engine's first sample
    as an increase from zero (a replay that happened BEFORE the engine
    started — i.e. at daemon startup — still alerts for one window).
``burn_rate``
    the classic multi-window error-budget burn over a latency
    histogram: the fraction of observations above ``objective_s``
    within the trailing ``short_s`` AND ``long_s`` windows must BOTH
    exceed ``budget * burn`` to fire (the long window keeps a steady
    slow-burn visible, the short window makes the alert resolve fast
    once the bleeding stops).

Severity is ``warn`` or ``page``; the engine's verdict is ``failing``
if any page-severity rule fires, ``degraded`` if only warnings fire,
``ok`` otherwise — rendered as exit codes 0/1/2 by ``pafreport health
--exit-code`` for orchestrator probes.

Stdlib only, like the rest of ``pwasm_tpu_torch/obs/``: the ``top``
and ``health`` client processes load it without torch.  Evaluation
never raises into the serving loop it monitors: a rule over a metric
that does not exist (a user rule with a typo) simply reports no data.
"""

from __future__ import annotations

import json
import threading
import time

SEVERITIES = ("warn", "page")
KINDS = ("threshold", "rate", "burn_rate")
OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}

# verdict ranking: worst-of aggregation (the router folds member
# verdicts with max over these ranks)
VERDICT_RANK = {"ok": 0, "degraded": 1, "failing": 2}
RANK_VERDICT = {v: k for k, v in VERDICT_RANK.items()}


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_rule(rule: dict) -> dict:
    """Validate one rule dict (raises ``ValueError`` with a pointed
    diagnostic) and return it normalized — shared by the default-rule
    catalog and ``--slo-rules`` user files, so the two grammars cannot
    drift."""
    if not isinstance(rule, dict):
        raise ValueError(f"rule must be an object, got {type(rule).__name__}")
    name = rule.get("name")
    if not isinstance(name, str) \
            or not name.replace("_", "a").isalnum() \
            or name != name.lower():
        raise ValueError(f"rule name {name!r} must be lower_snake_case")
    out = {"name": name}
    sev = rule.get("severity", "warn")
    if sev not in SEVERITIES:
        raise ValueError(f"rule {name}: severity {sev!r} not in "
                         f"{SEVERITIES}")
    out["severity"] = sev
    kind = rule.get("kind", "threshold")
    if kind not in KINDS:
        raise ValueError(f"rule {name}: kind {kind!r} not in {KINDS}")
    out["kind"] = kind
    metric = rule.get("metric")
    if not isinstance(metric, str) or not metric:
        raise ValueError(f"rule {name}: metric must be a metric name")
    out["metric"] = metric
    out["runbook"] = str(rule.get("runbook") or "")
    if kind in ("threshold", "rate"):
        op = rule.get("op", ">")
        if op not in OPS:
            raise ValueError(f"rule {name}: op {op!r} not in "
                             f"{sorted(OPS)}")
        out["op"] = op
        if not _num(rule.get("value")):
            raise ValueError(f"rule {name}: value must be a number")
        out["value"] = float(rule["value"])
    if kind == "threshold":
        div = rule.get("divide_by")
        if div is not None and (not isinstance(div, str) or not div):
            raise ValueError(f"rule {name}: divide_by must be a "
                             "metric name")
        out["divide_by"] = div
        for_s = rule.get("for_s", 0.0)
        if not _num(for_s) or for_s < 0:
            raise ValueError(f"rule {name}: for_s must be >= 0")
        out["for_s"] = float(for_s)
    elif kind == "rate":
        window = rule.get("window_s", 300.0)
        if not _num(window) or window <= 0:
            raise ValueError(f"rule {name}: window_s must be > 0")
        out["window_s"] = float(window)
        baseline = rule.get("baseline", "first")
        if baseline not in ("first", "zero"):
            raise ValueError(f"rule {name}: baseline must be "
                             "'first' or 'zero'")
        out["baseline"] = baseline
    else:   # burn_rate
        for key, dflt, lo in (("objective_s", None, 0.0),
                              ("budget", None, 0.0),
                              ("short_s", 60.0, 0.0),
                              ("long_s", 300.0, 0.0),
                              ("burn", 1.0, 0.0)):
            v = rule.get(key, dflt)
            if not _num(v) or not v > lo:
                raise ValueError(f"rule {name}: {key} must be a "
                                 f"number > {lo}")
            out[key] = float(v)
        if out["short_s"] >= out["long_s"]:
            raise ValueError(f"rule {name}: short_s must be < long_s")
    unknown = set(rule) - set(out)
    if unknown:
        raise ValueError(f"rule {name}: unknown field(s) "
                         f"{sorted(unknown)}")
    return out


def parse_rules(rules) -> list[dict]:
    """Validate a list of rule dicts; duplicate names are an error
    (one name = one alert series)."""
    if not isinstance(rules, list):
        raise ValueError("SLO rules must be a JSON list of rule "
                         "objects")
    out = []
    seen: set[str] = set()
    for r in rules:
        v = validate_rule(r)
        if v["name"] in seen:
            raise ValueError(f"duplicate rule name {v['name']!r}")
        seen.add(v["name"])
        out.append(v)
    return out


def load_rules_file(path: str) -> list[dict]:
    """Parse a ``--slo-rules=FILE`` JSON document (a list of rule
    dicts).  Raises ``ValueError`` with a diagnostic naming the file
    on any problem — the serve/route entry points render it as the
    usual usage error."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except OSError as e:
        raise ValueError(f"cannot read --slo-rules {path}: {e}")
    except json.JSONDecodeError as e:
        raise ValueError(f"--slo-rules {path} is not valid JSON: {e}")
    try:
        return parse_rules(doc)
    except ValueError as e:
        raise ValueError(f"--slo-rules {path}: {e}")


def merge_rules(defaults: list[dict],
                extra: list[dict] | None) -> list[dict]:
    """Defaults + user rules; a user rule with a default's name
    REPLACES it (so an operator can retune a shipped threshold
    without forking the whole set)."""
    if not extra:
        return list(defaults)
    by_name = {r["name"]: r for r in defaults}
    for r in extra:
        by_name[r["name"]] = r
    return list(by_name.values())


class _RuleState:
    """Per-rule evaluation state: firing latch, pending clock
    (``for_s``), the bounded sample history rate/burn rules
    difference against, and the never-evicted FIRST sample (the
    ``baseline: "first"`` anchor — it must survive no matter how
    densely an external prober forces evaluations)."""

    __slots__ = ("rule", "firing", "since", "pending_since",
                 "detail", "value", "samples", "first")

    def __init__(self, rule: dict):
        self.rule = rule
        self.firing = False
        self.since: float | None = None        # wall, fire time
        self.pending_since: float | None = None
        self.detail = ""
        self.value: float | None = None
        self.first: tuple | None = None
        from collections import deque
        # baselines only (the current value is read live): appends
        # are TIME-SPACED at window/128, so the deque covers the full
        # window at any evaluation cadence — a health prober hammering
        # evaluate() can never evict the left-of-window baseline
        # (maxlen is a pure memory backstop)
        self.samples: deque = deque(maxlen=4096)

    def sample(self, now: float, row: tuple, window_s: float) -> None:
        """Record ``row`` (t-first) as baseline history, time-spaced."""
        if self.first is None:
            self.first = row
        if not self.samples \
                or now - self.samples[-1][0] >= window_s / 128.0:
            self.samples.append(row)


class SloEngine:
    """Evaluate a rule set over a registry on a timer.

    ``metrics`` is the ``build_slo_metrics`` dict (``firing`` gauge +
    ``transitions`` counter — obs/catalog.py); ``on_event`` receives
    ``(event, **fields)`` for firing/resolved transitions (the daemon
    wires it to ``Observability.event`` so transitions land in the
    NDJSON log in order).  Both optional — the engine also runs bare
    in tests.

    Thread-safety: ``evaluate`` takes the engine lock for the whole
    pass (the accept loop, the health verb, and the stats verb may
    all trigger it); registry reads snapshot under each family's own
    lock.
    """

    def __init__(self, registry, rules: list[dict],
                 metrics: dict | None = None, on_event=None,
                 eval_interval_s: float = 1.0):
        self.registry = registry
        self.rules = parse_rules(list(rules))
        self.metrics = metrics or {}
        self.on_event = on_event
        self.eval_interval_s = max(0.01, float(eval_interval_s))
        self._states = {r["name"]: _RuleState(r) for r in self.rules}
        self._lock = threading.Lock()
        self._last_eval = 0.0       # monotonic
        self._evaluations = 0
        # a rule's firing gauge must EXIST from the start (an absent
        # series looks like a scrape gap, not health)
        firing = self.metrics.get("firing")
        if firing is not None:
            for r in self.rules:
                firing.set(0, rule=r["name"])

    # ---- evaluation ----------------------------------------------------
    def due(self) -> bool:
        return time.monotonic() - self._last_eval \
            >= self.eval_interval_s

    def evaluate(self, now: float | None = None) -> dict:
        """One evaluation pass; returns :meth:`verdict`.  Never raises
        — a broken rule (user typo, schema drift) evaluates as
        no-data, not a crashed serving loop."""
        now = time.time() if now is None else now
        with self._lock:
            self._last_eval = time.monotonic()
            self._evaluations += 1
            for st in self._states.values():
                try:
                    cond, value, detail = self._eval_rule(st, now)
                except Exception as e:      # defensive by contract
                    cond, value = False, None
                    detail = f"rule evaluation error: {e}"
                self._transition(st, cond, value, detail, now)
            return self._verdict_locked(now)

    def _metric_cells(self, name: str):
        m = self.registry.get(name)
        return m.snapshot_cells() if m is not None else []

    def _scalar_cells(self, name: str) -> list[tuple[dict, float]]:
        out = []
        for labels, snap in self._metric_cells(name):
            if _num(snap):
                out.append((labels, float(snap)))
        return out

    def _eval_rule(self, st: _RuleState, now: float):
        r = st.rule
        if r["kind"] == "threshold":
            return self._eval_threshold(r)
        if r["kind"] == "rate":
            return self._eval_rate(st, now)
        return self._eval_burn(st, now)

    def _eval_threshold(self, r: dict):
        cells = self._scalar_cells(r["metric"])
        if not cells:
            return False, None, "no data"
        denom = None
        if r.get("divide_by"):
            denom = sum(v for _l, v in
                        self._scalar_cells(r["divide_by"]))
            if denom <= 0:
                return False, None, "no data (zero denominator)"
        op = OPS[r["op"]]
        worst = None
        for labels, v in cells:
            val = v / denom if denom is not None else v
            if op(val, r["value"]):
                # any-cell semantics: the FIRST matching cell names
                # the offender (labels in the detail)
                lbl = ",".join(f"{k}={v2}" for k, v2 in
                               sorted(labels.items()))
                detail = (f"{r['metric']}"
                          + (f"{{{lbl}}}" if lbl else "")
                          + (f" / {r['divide_by']}"
                             if denom is not None else "")
                          + f" = {round(val, 6)} {r['op']} "
                          f"{r['value']}")
                return True, round(val, 6), detail
            if worst is None:
                worst = val
        return False, round(worst, 6) if worst is not None else None, ""

    def _counter_total(self, name: str) -> float | None:
        cells = self._scalar_cells(name)
        if not cells:
            return None
        return sum(v for _l, v in cells)

    def _eval_rate(self, st: _RuleState, now: float):
        r = st.rule
        total = self._counter_total(r["metric"])
        if total is None:
            # a REGISTERED family with no cells truly reads zero (a
            # counter nobody incremented yet) — only an unknown
            # metric name (user-rule typo) is genuinely no-data.
            # Sampling the zero matters: the first increment must
            # diff against it, not become the invisible baseline.
            if self.registry.get(r["metric"]) is None:
                return False, None, "no data"
            total = 0.0
        window = r["window_s"]
        st.sample(now, (now, total), window)
        # baseline: the newest sample at or before the window's left
        # edge, else the never-evicted first sample (or literal zero
        # when the rule says pre-engine history counts)
        base = None
        for t, v in st.samples:
            if t <= now - window:
                base = v
            else:
                break
        if base is None:
            base = 0.0 if r["baseline"] == "zero" else st.first[1]
        # drop samples that can no longer be a baseline (keep one
        # left-of-window sample)
        while len(st.samples) >= 2 \
                and st.samples[1][0] <= now - window:
            st.samples.popleft()
        increase = max(0.0, total - base)
        cond = OPS[r["op"]](increase, r["value"])
        detail = (f"increase({r['metric']}[{int(window)}s]) = "
                  f"{round(increase, 6)} {r['op']} {r['value']}") \
            if cond else ""
        return cond, round(increase, 6), detail

    def _eval_burn(self, st: _RuleState, now: float):
        r = st.rule
        m = self.registry.get(r["metric"])
        if m is None or not hasattr(m, "buckets"):
            return False, None, "no data"
        # sum the raw bucket counts over every labeled cell, then
        # count observations <= the smallest bucket bound covering the
        # objective (conservative: an objective between bounds uses
        # the bound ABOVE it)
        cells = m.snapshot_cells()
        if not cells:
            return False, None, "no data"
        n_b = len(m.buckets)
        counts = [0] * (n_b + 1)
        for _labels, snap in cells:
            raw = snap[0]
            for i, c in enumerate(raw):
                counts[i] += c
        # objective past every finite bound: the +Inf bucket cannot
        # distinguish meets-objective from misses, so ALL observations
        # count good — the rule degrades to never-fires (honest),
        # instead of flagging observations that may meet the objective
        le_idx = n_b + 1
        for i, b in enumerate(m.buckets):
            if b >= r["objective_s"]:
                le_idx = i + 1
                break
        total = sum(counts)
        good = sum(counts[:le_idx])
        st.sample(now, (now, total, good), r["long_s"])
        burns = []
        for window in (r["short_s"], r["long_s"]):
            base_tot = base_good = None
            for t, tot, g in st.samples:
                if t <= now - window:
                    base_tot, base_good = tot, g
                else:
                    break
            if base_tot is None:
                base_tot, base_good = st.first[1], st.first[2]
            d_tot = total - base_tot
            d_bad = max(0, d_tot - (good - base_good))
            frac = d_bad / d_tot if d_tot > 0 else 0.0
            burns.append((frac, d_tot))
        while len(st.samples) >= 2 \
                and st.samples[1][0] <= now - r["long_s"]:
            st.samples.popleft()
        limit = r["budget"] * r["burn"]
        cond = all(frac > limit and d_tot > 0
                   for frac, d_tot in burns)
        short_frac = round(burns[0][0], 6)
        detail = (f"{r['metric']} > {r['objective_s']}s fraction "
                  f"{short_frac} (short) / {round(burns[1][0], 6)} "
                  f"(long) > budget {limit}") if cond else ""
        return cond, short_frac, detail

    def _transition(self, st: _RuleState, cond: bool,
                    value, detail: str, now: float) -> None:
        r = st.rule
        if cond:
            if st.pending_since is None:
                st.pending_since = now
            held = now - st.pending_since
            if not st.firing and (r["kind"] != "threshold"
                                  or held >= r.get("for_s", 0.0)):
                st.firing = True
                st.since = now
                st.value, st.detail = value, detail
                self._note(r, "firing", value=value, detail=detail)
            elif st.firing:
                st.value, st.detail = value, detail
        else:
            st.pending_since = None
            if st.firing:
                st.firing = False
                st.since = None
                st.value, st.detail = value, ""
                self._note(r, "resolved", value=value)

    def _note(self, rule: dict, state: str, value=None,
              detail: str | None = None) -> None:
        firing = self.metrics.get("firing")
        if firing is not None:
            firing.set(1 if state == "firing" else 0,
                       rule=rule["name"])
        trans = self.metrics.get("transitions")
        if trans is not None:
            trans.inc(rule=rule["name"], state=state)
        if self.on_event is not None:
            try:
                self.on_event(
                    "alert_" + state, rule=rule["name"],
                    severity=rule["severity"], value=value,
                    detail=detail or None)
            except Exception:
                pass     # the never-raises contract

    # ---- verdict -------------------------------------------------------
    def firing(self) -> list[dict]:
        with self._lock:
            return self._firing_locked(time.time())

    def _firing_locked(self, now: float) -> list[dict]:
        out = []
        for st in self._states.values():
            if st.firing:
                out.append({
                    "rule": st.rule["name"],
                    "severity": st.rule["severity"],
                    "since_s": round(max(0.0, now - (st.since or now)),
                                     3),
                    "value": st.value,
                    "detail": st.detail,
                    "runbook": st.rule["runbook"] or None,
                })
        out.sort(key=lambda f: (f["severity"] != "page", f["rule"]))
        return out

    def verdict(self) -> dict:
        with self._lock:
            return self._verdict_locked(time.time())

    def _verdict_locked(self, now: float) -> dict:
        firing = self._firing_locked(now)
        if any(f["severity"] == "page" for f in firing):
            verdict = "failing"
        elif firing:
            verdict = "degraded"
        else:
            verdict = "ok"
        return {"verdict": verdict, "firing": firing,
                "rules": len(self.rules),
                "evaluations": self._evaluations}


def worst_verdict(*verdicts: str) -> str:
    """The fleet aggregation: worst of N verdict strings (unknown
    strings rank as degraded — an unparseable member answer must not
    read as healthy)."""
    rank = max((VERDICT_RANK.get(v, 1) for v in verdicts), default=0)
    return RANK_VERDICT[rank]


def verdict_exit_code(verdict: str) -> int:
    """``health --exit-code`` mapping: ok=0, degraded=1, failing=2
    (anything unrecognized ranks degraded, same rule as aggregation)."""
    return VERDICT_RANK.get(verdict, 1)
