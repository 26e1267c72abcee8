"""The metric catalog: every pwasm metric, registered in ONE place.

Counterpart of ``pwasm_tpu/obs/catalog.py``, copied whole (the same
names, help texts and exposition).  This module is the namespace of
record for the fleet-facing metric surface (documented operator-side in
``docs/OBSERVABILITY.md``).  A static test
(``tests/test_torch_obs.py::test_catalog_is_the_only_registration_site``)
enforces two rules that keep it authoritative:

- every registration call (``registry.counter/gauge/histogram``) in
  ``pwasm_tpu_torch/`` lives HERE — call sites elsewhere receive the built
  metric objects, never invent names inline;
- every name literal here matches the grammar (snake_case, ``pwasm_``
  prefix) and appears exactly once — a duplicate is a lint failure
  before it is a runtime ``ValueError``.

Two builders: :func:`build_run_metrics` (the per-run families — the
one-shot CLI registers them for ``--metrics-textfile``, and the serve
daemon registers the same families once and FOLDS every finished job's
``--stats`` JSON into them via :func:`fold_run_stats`, so the cumulative
fleet counters and the per-run stats schema cannot drift) and
:func:`build_service_metrics` (the daemon-only families: queue/admission
gauges, job outcome counters, wall/queue-wait histograms, the result
eviction counter).
"""

from __future__ import annotations

from pwasm_tpu_torch.obs.metrics import MetricsRegistry

# histogram buckets for per-job queue wait (admission latency: instant
# under a drained queue, up to many job-walls when saturated)
_WAIT_BUCKETS = (0.001, 0.005, 0.025, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0,
                 300.0)

# breaker-state gauge encoding (both surfaces use it; see
# docs/OBSERVABILITY.md)
BREAKER_CLOSED = 0
BREAKER_HALF_OPEN = 1
BREAKER_OPEN = 2


def breaker_state_value(breaker_open: bool,
                        monitor_state: str | None = None) -> int:
    """The gauge encoding of the breaker triple: 0 closed (device
    path live), 1 half-open (open but probing healthy — recovery in
    progress), 2 open (degraded to host)."""
    if not breaker_open:
        return BREAKER_CLOSED
    if monitor_state == "half-open":
        return BREAKER_HALF_OPEN
    return BREAKER_OPEN


def build_run_metrics(reg: MetricsRegistry,
                      include_live: bool = True) -> dict:
    """Register the per-run metric families; returns them keyed by the
    short names :func:`fold_run_stats` and the supervisor's observe
    hook use.  ``include_live=False`` (the serve daemon) registers
    only the foldable counters: the live instruments — the per-attempt
    histogram and the run breaker gauge — are fed by the RUN's own obs
    bundle, which a served job only has when it passed obs flags
    itself, and an advertised family that can never carry a sample
    would just feed no-data alerts."""
    m = {}
    if include_live:
        m["batch_attempt_seconds"] = reg.histogram(
            "pwasm_run_batch_attempt_seconds",
            "Wall seconds per supervised device-batch attempt, by "
            "site (one-shot CLI runs)", labels=("site",))
        m["breaker_state"] = reg.gauge(
            "pwasm_run_breaker_state",
            "Global circuit breaker: 0 closed, 1 half-open, 2 open "
            "(one-shot CLI runs)")
    m["runs"] = reg.counter(
        "pwasm_run_finished_total",
        "Finished runs folded into this registry, by outcome",
        labels=("outcome",))
    m["wall_seconds"] = reg.counter(
        "pwasm_run_wall_seconds_total",
        "Cumulative run wall seconds")
    m["alignments"] = reg.counter(
        "pwasm_run_alignments_total",
        "Alignments accepted for analysis")
    m["events"] = reg.counter(
        "pwasm_run_events_total", "Diff events reported")
    m["aligned_bases"] = reg.counter(
        "pwasm_run_aligned_bases_total",
        "Sum of per-alignment target span bases")
    m["host_stage_seconds"] = reg.counter(
        "pwasm_host_stage_seconds_total",
        "Cumulative host report-path stage wall seconds, by stage "
        "(parse/extract/analyze/format)", labels=("stage",))
    m["device_dispatches"] = reg.counter(
        "pwasm_device_dispatches_total", "Device program launches")
    m["device_flushes"] = reg.counter(
        "pwasm_device_flushes_total",
        "Host-blocking device round-trips")
    m["fallback_batches"] = reg.counter(
        "pwasm_device_fallback_batches_total",
        "Device batches replayed on the host scalar path")
    m["engine_fallbacks"] = reg.counter(
        "pwasm_engine_fallbacks_total",
        "Engine/device stage demotions in the MSA consensus path")
    m["backend_probes"] = reg.counter(
        "pwasm_backend_probes_total",
        "Bounded subprocess backend probes paid")
    m["backend_warm_hits"] = reg.counter(
        "pwasm_backend_warm_hits_total",
        "Backend reachability checks answered from warm state")
    m["retries"] = reg.counter(
        "pwasm_resilience_retries_total",
        "Re-executed supervised device attempts")
    m["fallbacks"] = reg.counter(
        "pwasm_resilience_fallbacks_total",
        "Supervised batches degraded to the host path")
    m["guardrail_rejects"] = reg.counter(
        "pwasm_resilience_guardrail_rejects_total",
        "Device outputs rejected as corrupt by guardrails")
    m["deadline_timeouts"] = reg.counter(
        "pwasm_resilience_deadline_timeouts_total",
        "Attempts abandoned past --device-deadline")
    m["breaker_trips"] = reg.counter(
        "pwasm_breaker_trips_total",
        "Global breaker opens (probe-confirmed dead backend)")
    m["site_breaker_trips"] = reg.counter(
        "pwasm_site_breaker_trips_total",
        "Per-site breaker opens on a healthy backend")
    m["breaker_recloses"] = reg.counter(
        "pwasm_breaker_recloses_total",
        "Global breaker recloses (mid-run device re-promotion)")
    m["reprobe_attempts"] = reg.counter(
        "pwasm_reprobe_attempts_total",
        "Bounded backend re-probes while the breaker was open")
    m["degraded_batches"] = reg.counter(
        "pwasm_degraded_batches_total",
        "Batches skipped straight to the host (breaker open)")
    m["recovered_batches"] = reg.counter(
        "pwasm_recovered_batches_total",
        "Device batches executed after a reclose")
    m["degraded_wall_seconds"] = reg.counter(
        "pwasm_degraded_wall_seconds_total",
        "Wall seconds spent with the global breaker open")
    m["injected_faults"] = reg.counter(
        "pwasm_injected_faults_total",
        "Faults injected by --inject-faults (debug)")
    m["checkpoints"] = reg.counter(
        "pwasm_checkpoints_total",
        "Durable batch checkpoints written")
    m["oom_events"] = reg.counter(
        "pwasm_oom_events_total",
        "Device allocation failures (real or injected)")
    m["batch_splits"] = reg.counter(
        "pwasm_batch_splits_total", "Batches bisected after an OOM")
    m["bucket_demotions"] = reg.counter(
        "pwasm_bucket_demotions_total",
        "Pow2 batch-ceiling demotions after an OOM")
    m["bucket_repromotions"] = reg.counter(
        "pwasm_bucket_repromotions_total",
        "Probation-raises of a demoted batch ceiling")
    # trace health: drops surfaced live, not only
    # in otherData at write time (fed by TraceRecorder.on_drop)
    m["trace_dropped"] = reg.counter(
        "pwasm_trace_events_dropped_total",
        "Trace events dropped past --trace-max-events (or a "
        "contended recorder lock)")
    # utilization accounting: pow2 padding waste and the
    # compile-vs-steady device wall split, folded from the --stats
    # device block; the ratio gauges are derived from the cumulative
    # counters at fold time
    m["pad_items"] = reg.counter(
        "pwasm_device_pad_items_total",
        "Live event rows launched in pow2-padded device batches")
    m["pad_slots"] = reg.counter(
        "pwasm_device_pad_slots_total",
        "Total slots (live + pad) launched in pow2-padded device "
        "batches")
    m["pad_waste"] = reg.gauge(
        "pwasm_device_pad_waste_ratio",
        "Fraction of launched device-batch slots that were pow2 "
        "bucket padding (cumulative; 0 = perfectly full buckets)")
    m["compile_seconds"] = reg.counter(
        "pwasm_device_compile_seconds_total",
        "Wall seconds of each supervised site's FIRST attempt "
        "(compile-inclusive)")
    m["steady_seconds"] = reg.counter(
        "pwasm_device_steady_seconds_total",
        "Wall seconds of supervised attempts after a site's first "
        "(steady-state, compile-cache warm)")
    m["compile_fraction"] = reg.gauge(
        "pwasm_device_compile_fraction",
        "Compile-inclusive fraction of supervised device wall "
        "(cumulative compile / (compile + steady))")
    return m


def build_service_metrics(reg: MetricsRegistry) -> dict:
    """Register the serve-daemon families (queue, admission, job
    outcomes, result eviction) keyed by short names the daemon uses."""
    m = {}
    m["queue_depth"] = reg.gauge(
        "pwasm_service_queue_depth", "Jobs waiting in the admission queue")
    m["inflight"] = reg.gauge(
        "pwasm_service_jobs_inflight", "Jobs currently executing")
    m["draining"] = reg.gauge(
        "pwasm_service_draining",
        "1 while the service drain is latched, else 0")
    m["breaker_state"] = reg.gauge(
        "pwasm_service_breaker_state",
        "Warm-pool breaker: 0 closed, 1 half-open, 2 open")
    m["max_queue"] = reg.gauge(
        "pwasm_service_max_queue", "Admission-control queue ceiling")
    m["max_concurrent"] = reg.gauge(
        "pwasm_service_max_concurrent", "Worker-pool width")
    m["results_held"] = reg.gauge(
        "pwasm_service_results_held",
        "Terminal job results currently retained for pickup")
    # device-lease scheduler: lane inventory + wait surface
    m["lanes"] = reg.gauge(
        "pwasm_service_lanes",
        "Device-lease lanes the daemon schedules jobs onto")
    m["lanes_busy"] = reg.gauge(
        "pwasm_service_lanes_busy", "Lanes currently leased to a job")
    m["lease_waiting"] = reg.gauge(
        "pwasm_service_lease_waiting_jobs",
        "Dequeued jobs waiting for a free device lease")
    m["lane_breaker_state"] = reg.gauge(
        "pwasm_service_lane_breaker_state",
        "Per-lane breaker: 0 closed, 1 half-open, 2 open",
        labels=("lane",))
    m["lane_jobs"] = reg.counter(
        "pwasm_service_lane_jobs_total",
        "Jobs completed per device-lease lane", labels=("lane",))
    m["lane_busy_fraction"] = reg.gauge(
        "pwasm_service_lane_busy_fraction",
        "Fraction of the daemon's uptime each lane spent leased to a "
        "job (per-lane device busy-fraction)", labels=("lane",))
    m["lease_wait_seconds"] = reg.histogram(
        "pwasm_service_lease_wait_seconds",
        "Per-job device-lease wait seconds (dequeue to grant)",
        buckets=_WAIT_BUCKETS)
    # crash-safe serving: journal, spool, fair-share
    m["journal_records"] = reg.counter(
        "pwasm_service_journal_records_total",
        "Durable job-journal records appended, by record type "
        "(admit/start/finish/cancel/evict)", labels=("rec",))
    m["journal_replays"] = reg.counter(
        "pwasm_service_journal_replays_total",
        "Journal replays performed at daemon start (each one is a "
        "recovery from a hard crash)")
    m["spool_bytes"] = reg.gauge(
        "pwasm_service_spool_bytes",
        "Bytes of finished-job results spooled to disk "
        "(RAM holds only index entries for these)")
    m["client_queue_depth"] = reg.gauge(
        "pwasm_service_client_queue_depth",
        "Queued jobs per fair-share client identity",
        labels=("client",))
    m["jobs"] = reg.counter(
        "pwasm_service_jobs_total",
        "Job admissions and outcomes, by outcome "
        "(accepted/rejected/rejected_draining/done/failed/"
        "preempted/cancelled)", labels=("outcome",))
    m["results_evicted"] = reg.counter(
        "pwasm_service_results_evicted_total",
        "Terminal job results evicted by --result-ttl-s/--max-results")
    m["job_wall_seconds"] = reg.histogram(
        "pwasm_service_job_wall_seconds",
        "Per-job wall seconds (start to finish)")
    m["queue_wait_seconds"] = reg.histogram(
        "pwasm_service_job_queue_wait_seconds",
        "Per-job queue wait seconds (submit to start)",
        buckets=_WAIT_BUCKETS)
    # epoch-lease fencing (fleet/fencing.py): a router-
    # governed member's split-brain guards
    m["fenced"] = reg.gauge(
        "pwasm_service_fenced",
        "1 while this member is fenced (lost/expired epoch lease: "
        "new work refused, in-flight drained to checkpoints), else 0")
    m["member_epoch"] = reg.gauge(
        "pwasm_service_member_epoch",
        "Highest fleet epoch this member has accepted a lease under "
        "(monotonic; compare with pwasm_fleet_epoch to spot a member "
        "heartbeating a stale router)")
    m["fences"] = reg.counter(
        "pwasm_service_fences_total",
        "Times this member self-fenced (lease TTL expiry or an "
        "explicit fence command) — each one is a suspected "
        "router-side failover where this member was the zombie")
    return m


def build_stream_metrics(reg: MetricsRegistry) -> dict:
    """Register the streaming-ingestion families, labeled
    by the stream's fair-share client identity.  ``records``/``batches``
    count what actually flowed; ``lag`` is the live fed-but-unconsumed
    buffer depth per client — the "is a producer outrunning its
    consumer" pressure signal the per-stream quota acts on."""
    m = {}
    m["records"] = reg.counter(
        "pwasm_stream_records_total",
        "PAF records accepted over stream-data frames, by client",
        labels=("client",))
    m["batches"] = reg.counter(
        "pwasm_stream_batches_total",
        "Arrival batches drained from stream buffers by executing "
        "jobs, by client", labels=("client",))
    m["lag"] = reg.gauge(
        "pwasm_stream_lag_records",
        "Records fed to a stream but not yet consumed by its job, "
        "by client", labels=("client",))
    m["lag_age"] = reg.gauge(
        "pwasm_stream_lag_age_seconds",
        "Age of the oldest fed-but-unconsumed stream record, by "
        "client (how STALE the lag is, where lag_records says how "
        "deep)", labels=("client",))
    return m


def build_m2m_metrics(reg: MetricsRegistry) -> dict:
    """Register the continuous-surveillance families
    (``--m2m-stream``): counters fold each FINISHED session's flow
    (the daemon reads them from the session's ``--stats`` m2m block),
    gauges describe the live ones — the svc-stats ``m2m`` block and
    the ``top`` M2M pane read the same numbers."""
    m = {}
    m["sessions"] = reg.counter(
        "pwasm_m2m_sessions_total",
        "Finished --m2m-stream surveillance sessions")
    m["targets_in"] = reg.counter(
        "pwasm_m2m_targets_total",
        "Target records admitted by finished m2m-stream sessions")
    m["targets_scored"] = reg.counter(
        "pwasm_m2m_targets_scored_total",
        "Targets that needed at least one device dispatch (some "
        "resident pair was not in the section cache)")
    m["targets_reused"] = reg.counter(
        "pwasm_m2m_targets_reused_total",
        "Targets served ENTIRELY from the section cache's family "
        "pool — zero device work")
    m["pairs_dispatched"] = reg.counter(
        "pwasm_m2m_pairs_dispatched_total",
        "(query, target) pairs scored on the device by m2m-stream "
        "sessions")
    m["pairs_reused"] = reg.counter(
        "pwasm_m2m_pairs_reused_total",
        "(query, target) pairs spliced verbatim from cached section "
        "scores instead of dispatched")
    m["batches"] = reg.counter(
        "pwasm_m2m_batches_total",
        "Arrival batches dispatched by m2m-stream sessions")
    m["sections"] = reg.counter(
        "pwasm_m2m_sections_emitted_total",
        "Per-CDS report sections emitted by finished m2m-stream "
        "sessions")
    m["active"] = reg.gauge(
        "pwasm_m2m_active_sessions",
        "Live m2m-stream sessions currently feeding or scoring")
    m["live_targets"] = reg.gauge(
        "pwasm_m2m_live_targets",
        "Targets admitted so far by the LIVE sessions (in-flight "
        "progress, not yet folded into the counters)")
    m["reuse_ratio"] = reg.gauge(
        "pwasm_m2m_reuse_ratio",
        "Cumulative fraction of (query, target) pairs served from "
        "the section cache across finished AND live sessions — the "
        "incremental-surveillance win in one number")
    return m


def build_cache_metrics(reg: MetricsRegistry) -> dict:
    """Register the content-addressed result-cache families
    (``service/cache.py``): flow counters (hits/misses/insertions/
    evictions), the live on-disk byte gauge (fed from the unified
    :class:`service.cache.ByteLedger`, so it cannot drift
    from the spool gauge's accounting), and the cumulative hit-ratio
    gauge the capacity-planning dashboards read.  Registered by the
    one-shot CLI (``--result-cache`` + ``--metrics-textfile``), the
    serve daemon, and the fleet router — each over its own registry."""
    m = {}
    m["hits"] = reg.counter(
        "pwasm_cache_hits_total",
        "Result-cache hits (jobs served from stored bytes with zero "
        "device/lease/queue involvement)")
    m["misses"] = reg.counter(
        "pwasm_cache_misses_total",
        "Result-cache lookups that found no whole, unexpired, "
        "CRC-clean entry")
    m["insertions"] = reg.counter(
        "pwasm_cache_insertions_total",
        "Completed jobs whose outputs were stored in the result cache")
    m["insert_errors"] = reg.counter(
        "pwasm_cache_insert_errors_total",
        "Result-cache inserts that failed and degraded to "
        "pass-through (ENOSPC and kin): the job was served from its "
        "real run, only the cache write was skipped")
    m["evictions"] = reg.counter(
        "pwasm_cache_evictions_total",
        "Result-cache entries dropped (LRU past "
        "--result-cache-max-bytes, TTL expiry, or CRC rot)")
    m["bytes"] = reg.gauge(
        "pwasm_cache_bytes",
        "Bytes of result-cache entries currently on disk")
    m["hit_ratio"] = reg.gauge(
        "pwasm_cache_hit_ratio",
        "Cumulative result-cache hit ratio ((hits + fractional delta "
        "serves) / lookups) — a delta serve counts records-served / "
        "records-total of a hit, so incremental traffic moves the "
        "ratio truthfully instead of reading as pure misses")
    m["delta_hits"] = reg.counter(
        "pwasm_cache_delta_hits_total",
        "Near-miss DELTA serves: jobs whose exact lookup "
        "missed but whose cached same-family prefix (or m2m target "
        "subset) was spliced in, recomputing only the tail")
    return m


def build_fleet_metrics(reg: MetricsRegistry) -> dict:
    """Register the fleet-router families (the ``pwasm-tpu route``
    daemon, docs/FLEET.md): member liveness and load as the router
    sees it, placement and failover counters, and the global
    fair-share ledger's per-client live-job gauge.  Labeled by the
    sanitized member name (``fleet/transport.py::target_name``) —
    the same identity the shared-journal placement policy uses."""
    m = {}
    m["members"] = reg.gauge(
        "pwasm_fleet_members",
        "Member serve daemons this router fronts")
    m["member_up"] = reg.gauge(
        "pwasm_fleet_member_up",
        "Member liveness as the router's health loop sees it "
        "(1 up, 0 down)", labels=("member",))
    m["member_queue_depth"] = reg.gauge(
        "pwasm_fleet_member_queue_depth",
        "Queued + running jobs per member at the last stats poll",
        labels=("member",))
    m["live_jobs"] = reg.gauge(
        "pwasm_fleet_jobs_live",
        "Routed jobs not yet terminal anywhere in the fleet")
    m["client_jobs"] = reg.gauge(
        "pwasm_fleet_client_jobs",
        "Live fleet-wide jobs per fair-share client identity (the "
        "global ledger the fleet quota is enforced against)",
        labels=("client",))
    m["routed"] = reg.counter(
        "pwasm_fleet_jobs_routed_total",
        "Jobs placed per member (least-loaded placement)",
        labels=("member",))
    m["jobs"] = reg.counter(
        "pwasm_fleet_jobs_total",
        "Router admissions by outcome (accepted/rejected)",
        labels=("outcome",))
    m["failovers"] = reg.counter(
        "pwasm_fleet_failovers_total",
        "Member-death events the router handled (each one is a "
        "journal-aware failover pass)")
    m["recovered"] = reg.counter(
        "pwasm_fleet_jobs_recovered_total",
        "Jobs recovered from dead members, by verdict (resumed/"
        "requeued/restored/cancelled/stream_preempted/failed)",
        labels=("how",))
    m["max_jobs"] = reg.gauge(
        "pwasm_fleet_max_jobs",
        "Fleet-wide live-job backstop (--max-queue-total) — the "
        "ledger_saturation SLO rule's denominator")
    # router HA: WAL, standby takeover, fencing, scaler
    m["epoch"] = reg.gauge(
        "pwasm_fleet_epoch",
        "Current fleet epoch (monotonic fencing token: bumped on "
        "every router restart/takeover and every member-death "
        "failover; members accept work only under a lease at it)")
    m["fenced_members"] = reg.gauge(
        "pwasm_fleet_members_fenced",
        "Reachable members currently reporting themselves fenced "
        "(self-fenced zombies waiting for a fresh lease)")
    m["takeovers"] = reg.counter(
        "pwasm_fleet_takeovers_total",
        "Warm-standby takeovers this router performed (route "
        "--standby-of promoted itself onto the primary's socket)")
    m["journal_records"] = reg.counter(
        "pwasm_fleet_journal_records_total",
        "Router write-ahead journal records appended, by record type "
        "(route_admit/route_place/route_retire/epoch/members/scale)",
        labels=("rec",))
    m["journal_replayed"] = reg.counter(
        "pwasm_fleet_journal_replayed_total",
        "Routed jobs rebuilt from the router WAL at start (each "
        "replay is a router crash or a standby takeover recovered)")
    m["scaler_members"] = reg.gauge(
        "pwasm_fleet_scaler_members",
        "Members currently alive that the SLO-driven scaler spawned "
        "(route --scale-policy)")
    m["scaler_actions"] = reg.counter(
        "pwasm_fleet_scaler_actions_total",
        "Auto-scaler actions taken, by action (spawn/retire)",
        labels=("action",))
    m["stale_rejected"] = reg.counter(
        "pwasm_fleet_stale_completions_total",
        "Terminal replies rejected at the router edge because the "
        "job had moved to a newer generation (a fenced zombie's "
        "completion arriving after failover re-placed the job)")
    # gray-failure defense: latency-outlier quarantine +
    # brownout shedding
    m["member_latency_ewma"] = reg.gauge(
        "pwasm_fleet_member_latency_ewma_ms",
        "EWMA of the member's health-poll round-trip latency in "
        "milliseconds — the slow-member outlier detector's input "
        "(a member sustaining >K x the fleet median is quarantined)",
        labels=("member",))
    m["member_quarantined"] = reg.gauge(
        "pwasm_fleet_member_quarantined",
        "1 while the member is quarantined as a latency outlier "
        "(alive but degraded: no new placements, existing jobs "
        "finish, probation-exits after clean polls), else 0",
        labels=("member",))
    m["quarantines"] = reg.counter(
        "pwasm_fleet_quarantines_total",
        "Quarantine entries (a live member crossed the latency "
        "outlier threshold) — each one is a gray failure the router "
        "routed around without a human",)
    m["shed"] = reg.counter(
        "pwasm_fleet_jobs_shed_total",
        "Admissions shed at the router edge under brownout (fleet "
        "queue pressure past the SLO threshold): answered a truthful "
        "overloaded + retry_after_s, lowest priority lane first, "
        "before any member saw the frame", labels=("lane",))
    m["shedding"] = reg.gauge(
        "pwasm_fleet_shedding",
        "1 while brownout shedding is active (hysteresis-damped), "
        "else 0")
    return m


def build_slo_metrics(reg: MetricsRegistry) -> dict:
    """Register the SLO-engine families: one firing gauge
    per rule (0/1 — every configured rule keeps a series from start,
    so an absent series is a scrape gap, never 'healthy') and the
    firing/resolved transition counter the incident timeline keys on.
    Registered by BOTH the serve daemon and the fleet router (each
    over its own registry and rule set)."""
    m = {}
    m["firing"] = reg.gauge(
        "pwasm_alerts_firing",
        "1 while the named SLO rule is firing, else 0 (obs/slo.py; "
        "rule catalog in docs/OBSERVABILITY.md)", labels=("rule",))
    m["transitions"] = reg.counter(
        "pwasm_alert_transitions_total",
        "SLO rule state transitions, by rule and state "
        "(firing/resolved)", labels=("rule", "state"))
    return m


def build_canary_metrics(reg: MetricsRegistry) -> dict:
    """Register the synthetic-canary families (service/canary.py,
    ``serve --canary-interval``): the last probe's verdict, the probe
    wall histogram (exemplar-linked to each probe's trace_id), and
    the run counter by outcome."""
    m = {}
    m["ok"] = reg.gauge(
        "pwasm_canary_ok",
        "1 if the last synthetic canary probe passed (rc 0 + golden "
        "report digest), 0 if it failed — unset until the first probe")
    m["wall_seconds"] = reg.histogram(
        "pwasm_canary_wall_seconds",
        "Wall seconds per synthetic canary probe (the full "
        "probe->lease->device->report path)")
    m["runs"] = reg.counter(
        "pwasm_canary_runs_total",
        "Synthetic canary probes, by outcome (ok/fail/skipped — "
        "skipped means no free lane within the grab timeout)",
        labels=("outcome",))
    return m


def build_transport_metrics(reg: MetricsRegistry) -> dict:
    """Register the zero-trust edge families: TLS
    handshake failures on the listener (downgrade probes, bad certs,
    mid-handshake disconnects — counted, never fatal to the accept
    loop) and per-client authorization refusals (the signal the
    ``auth_failure_burst`` SLO rule and the connection-level penalty
    box key on).  Registered by both the serve daemon and the fleet
    router over their own registries."""
    m = {}
    m["tls_handshake_failures"] = reg.counter(
        "pwasm_transport_tls_handshake_failures_total",
        "TLS handshakes that failed on the listener (plaintext "
        "probes, protocol downgrades below the TLS1.2 floor, "
        "untrusted or missing client certs under mTLS, mid-handshake "
        "disconnects) — each answered with a loud close, never a "
        "hang or an accept-loop crash")
    m["auth_failures"] = reg.counter(
        "pwasm_transport_auth_failures_total",
        "Frames refused with the `unauthorized` error, by resolved "
        "client identity (distinct label values are capped; overflow "
        "folds into `other`) — refusals change no queue/journal "
        "state and repeated failures earn a capped-exponential "
        "connection delay", labels=("client",))
    return m


# metric-name-lint: end-of-registrations (everything below REFERENCES
# registered families — SLO rule expressions — and is excluded from
# the registration-uniqueness scan of the catalog test)
# ---------------------------------------------------------------------------
# Default SLO rule sets: the alert sketches that lived as
# prose in docs/OBSERVABILITY.md, codified as declarative rules the
# engine (obs/slo.py) evaluates continuously.  Every rule name below
# must appear in docs/OBSERVABILITY.md — enforced by the doc-drift
# lint of the reference's qa/, same contract as
# the metric families.  User rules (serve/route --slo-rules=FILE)
# merge over these by name.
# ---------------------------------------------------------------------------

# the serve daemon's default rules, evaluated over its own registry
DEFAULT_SLO_RULES = (
    {"name": "breaker_open", "severity": "page", "kind": "threshold",
     "metric": "pwasm_service_breaker_state", "op": ">=", "value": 2,
     "for_s": 0.0,
     "runbook": "a lane's device backend is probe-confirmed dead and "
                "jobs are degrading to the host path; check the lane "
                "table in `pwasm-tpu top` and the chip"},
    {"name": "queue_pressure", "severity": "warn",
     "kind": "threshold", "metric": "pwasm_service_queue_depth",
     "divide_by": "pwasm_service_max_queue", "op": ">", "value": 0.8,
     "for_s": 5.0,
     "runbook": "admission queue is over 80% of one client quota; "
                "add members or raise --max-queue"},
    {"name": "journal_replay", "severity": "warn", "kind": "rate",
     "metric": "pwasm_service_journal_replays_total", "op": ">",
     "value": 0, "window_s": 300.0, "baseline": "zero",
     "runbook": "this daemon replayed its job journal within the "
                "window — it recovered from a hard crash; find out "
                "what killed it"},
    {"name": "trace_drops", "severity": "warn", "kind": "rate",
     "metric": "pwasm_trace_events_dropped_total", "op": ">",
     "value": 0, "window_s": 300.0,
     "runbook": "trace events are being dropped past "
                "--trace-max-events; raise the cap or trace less"},
    {"name": "canary_failing", "severity": "page",
     "kind": "threshold", "metric": "pwasm_canary_ok", "op": "==",
     "value": 0, "for_s": 0.0,
     "runbook": "the synthetic canary probe failed (bad rc or report "
                "digest drift): the submit->lease->device->report "
                "path is broken end to end — check canary_fail "
                "events via `pwasm-tpu logs`"},
    {"name": "job_wall_p99_burn", "severity": "warn",
     "kind": "burn_rate", "metric": "pwasm_service_job_wall_seconds",
     "objective_s": 120.0, "budget": 0.01, "short_s": 60.0,
     "long_s": 300.0, "burn": 1.0,
     "runbook": "more than 1% of jobs exceeded the 120s wall "
                "objective in both burn windows; inspect a slow "
                "job's flight record (`pwasm-tpu inspect JOB_ID`)"},
    {"name": "queue_wait_burn", "severity": "warn",
     "kind": "burn_rate",
     "metric": "pwasm_service_job_queue_wait_seconds",
     "objective_s": 60.0, "budget": 0.05, "short_s": 60.0,
     "long_s": 300.0, "burn": 1.0,
     "runbook": "over 5% of jobs waited more than 60s for admission "
                "in both burn windows — sustained overload; scale "
                "members out"},
    {"name": "cache_thrash", "severity": "warn", "kind": "threshold",
     "metric": "pwasm_cache_evictions_total",
     "divide_by": "pwasm_cache_insertions_total", "op": ">",
     "value": 0.9, "for_s": 10.0,
     "runbook": "the result cache is evicting nearly as fast as it "
                "inserts (sustained evictions/insertions > 0.9): a "
                "mis-sized --result-cache-max-bytes silently costs "
                "every repeat job its 100x hit — raise the budget or "
                "shrink the retained output set"},
    # zero-trust edge: a burst of unauthorized refusals
    # is either a misdeployed credential (a rotated token the client
    # fleet never picked up) or someone probing the control plane —
    # both want a human within the window.
    {"name": "auth_failure_burst", "severity": "warn", "kind": "rate",
     "metric": "pwasm_transport_auth_failures_total", "op": ">",
     "value": 10, "window_s": 60.0,
     "runbook": "more than 10 frames answered `unauthorized` within "
                "the window; a legitimate client is holding a stale "
                "token (rotate via --auth-tokens hot reload) or a "
                "peer is probing scopes — the penalty box is already "
                "damping it, check the per-client labels on "
                "pwasm_transport_auth_failures_total"},
)

# the fleet router's default rules, over the pwasm_fleet_* families
DEFAULT_FLEET_SLO_RULES = (
    {"name": "member_down", "severity": "page", "kind": "threshold",
     "metric": "pwasm_fleet_member_up", "op": "==", "value": 0,
     "for_s": 0.0,
     "runbook": "a member serve daemon is unreachable (failover ran "
                "or is running); check the member host and restart "
                "it WITHOUT its set-aside .recovered journal"},
    {"name": "failover_burst", "severity": "warn", "kind": "rate",
     "metric": "pwasm_fleet_failovers_total", "op": ">", "value": 0,
     "window_s": 300.0,
     "runbook": "the router handled member-death failover(s) within "
                "the window; if members are flapping, fix the hosts "
                "before the fleet runs out of siblings"},
    {"name": "ledger_saturation", "severity": "warn",
     "kind": "threshold", "metric": "pwasm_fleet_jobs_live",
     "divide_by": "pwasm_fleet_max_jobs", "op": ">", "value": 0.8,
     "for_s": 5.0,
     "runbook": "fleet-wide live jobs are over 80% of the admission "
                "backstop; clients will start seeing queue_full — "
                "add members or raise route --max-queue-total"},
    {"name": "member_fenced", "severity": "warn", "kind": "threshold",
     "metric": "pwasm_fleet_members_fenced", "op": ">", "value": 0,
     "for_s": 0.0,
     "runbook": "a reachable member is self-fenced (it lost its epoch "
                "lease and is refusing work); the next healthy stats "
                "poll re-grants the lease — if it stays fenced, the "
                "member is heartbeating a stale router: check for a "
                "zombie primary still holding the journal"},
    # gray-failure defense: the brownout trigger — member
    # queues saturated fleet-wide.  The router's shedding keys off
    # this rule (or ledger_saturation) firing; hysteresis lives in
    # the shed controller, the rule just states the pressure truth.
    {"name": "fleet_queue_pressure", "severity": "warn",
     "kind": "threshold",
     "metric": "pwasm_fleet_member_queue_depth", "op": ">",
     "value": 8, "for_s": 1.0,
     "runbook": "a member's queued+running depth is sustained past "
                "the brownout threshold; under --priority-lanes the "
                "router sheds the lowest lane with a truthful "
                "overloaded + retry_after_s until pressure clears — "
                "add members (or let --scale-policy spawn them) if "
                "it keeps firing"},
    {"name": "member_quarantined", "severity": "warn",
     "kind": "threshold",
     "metric": "pwasm_fleet_member_quarantined", "op": ">",
     "value": 0, "for_s": 0.0,
     "runbook": "a live member is a sustained latency outlier (>K x "
                "the fleet median poll round-trip) and is quarantined "
                "from new placements; it probation-exits by itself "
                "after clean polls — investigate the host (slow disk, "
                "GC stalls, half-partition) if it cycles in and out"},
)


def default_slo_rules() -> list[dict]:
    """The serve daemon's default rule set (fresh copies — the engine
    normalizes in place)."""
    return [dict(r) for r in DEFAULT_SLO_RULES]


def default_fleet_slo_rules() -> list[dict]:
    """The fleet router's default rule set."""
    return [dict(r) for r in DEFAULT_FLEET_SLO_RULES]


def fold_run_stats(m: dict, st: dict | None) -> None:
    """Fold one run's ``--stats`` JSON (the versioned ``stats_version``
    schema) into the run-metric families.  The one-shot CLI calls it
    once at end of run; the daemon calls it per finished job — so the
    Prometheus surface is a pure function of the same schema the
    ``--stats``/``svc-stats`` surfaces report, and the two cannot
    drift.  Unknown/missing keys fold as zero (additive-schema rule)."""
    if not isinstance(st, dict):
        return

    def n(d: dict, key: str) -> float:
        v = d.get(key, 0)
        return v if isinstance(v, (int, float)) \
            and not isinstance(v, bool) and v > 0 else 0

    res = st.get("resilience")
    res = res if isinstance(res, dict) else {}
    backend = st.get("backend")
    backend = backend if isinstance(backend, dict) else {}
    device = st.get("device")
    device = device if isinstance(device, dict) else {}
    m["runs"].inc(1, outcome="preempted" if st.get("preempted")
                  else "completed")
    m["wall_seconds"].inc(n(st, "wall_s"))
    m["alignments"].inc(n(st, "alignments"))
    m["events"].inc(n(st, "events"))
    m["aligned_bases"].inc(n(st, "aligned_bases"))
    m["device_dispatches"].inc(n(device, "dispatches"))
    m["device_flushes"].inc(n(device, "flushes"))
    # utilization accounting: fold the pad/compile counters
    # and derive the ratio gauges from the CUMULATIVE totals, so the
    # gauges describe the registry's whole history (a daemon's life),
    # not just the last folded run
    m["pad_items"].inc(n(device, "pad_items"))
    m["pad_slots"].inc(n(device, "pad_slots"))
    slots = m["pad_slots"].value()
    if slots > 0:
        m["pad_waste"].set(
            round(1.0 - m["pad_items"].value() / slots, 6))
    m["compile_seconds"].inc(n(device, "compile_s"))
    m["steady_seconds"].inc(n(device, "steady_s"))
    dev_wall = m["compile_seconds"].value() \
        + m["steady_seconds"].value()
    if dev_wall > 0:
        m["compile_fraction"].set(
            round(m["compile_seconds"].value() / dev_wall, 6))
    host = st.get("host")
    host = host if isinstance(host, dict) else {}
    for stage in ("parse", "extract", "analyze", "format"):
        m["host_stage_seconds"].inc(n(host, stage + "_s"),
                                    stage=stage)
    m["fallback_batches"].inc(n(st, "fallback_batches"))
    m["engine_fallbacks"].inc(n(st, "engine_fallbacks"))
    m["backend_probes"].inc(n(backend, "probes"))
    m["backend_warm_hits"].inc(n(backend, "warm_hits"))
    m["retries"].inc(n(res, "retries"))
    m["fallbacks"].inc(n(res, "fallbacks"))
    m["guardrail_rejects"].inc(n(res, "guardrail_rejects"))
    m["deadline_timeouts"].inc(n(res, "deadline_timeouts"))
    m["breaker_trips"].inc(n(res, "breaker_trips"))
    m["site_breaker_trips"].inc(n(res, "site_breaker_trips"))
    m["breaker_recloses"].inc(n(res, "breaker_recloses"))
    m["reprobe_attempts"].inc(n(res, "reprobe_attempts"))
    m["degraded_batches"].inc(n(res, "degraded_batches"))
    m["recovered_batches"].inc(n(res, "recovered_batches"))
    m["degraded_wall_seconds"].inc(n(res, "degraded_wall_s"))
    m["injected_faults"].inc(n(res, "injected_faults"))
    m["checkpoints"].inc(n(res, "checkpoints"))
    m["oom_events"].inc(n(res, "oom_events"))
    m["batch_splits"].inc(n(res, "batch_splits"))
    m["bucket_demotions"].inc(n(res, "bucket_demotions"))
    m["bucket_repromotions"].inc(n(res, "bucket_repromotions"))
