"""Fleet federation: many serve daemons, one submit surface.

Counterpart of ``pwasm_tpu/fleet/``:

- ``transport``  — the unix-socket and TCP transport: target parsing
  and connecting shared by :class:`~pwasm_tpu_torch.service.client.
  ServiceClient`, ``serve --listen`` and the router;
- ``fencing``    — :class:`~pwasm_tpu_torch.fleet.fencing.EpochLease`,
  the member side of the router's epoch lease (the ``lease-grant`` and
  ``fence`` verbs), and ``readmit_epoch_guard``, the router's;
- ``ledger``     — the global fair-share ledger: per-client fleet-wide
  admission quotas and placement accounting;
- ``router``     — the ``route`` daemon: full-protocol fan-out over N
  member daemons with least-depth placement, the write-ahead journal
  and epoch leases, slow-member quarantine and brownout shedding, the
  fleet result cache, and journal-aware failover (a member killed
  mid-job has its journal read and its started-unfinished jobs
  re-admitted to a sibling as ``--resume`` continuations), and the
  fleet-wide scatter of an ``--m2m-stream`` over its live members;
- ``standby``    — ``route --standby-of``: a warm standby that tails
  the primary router's journal and takes over its socket;
- ``scaler``     — ``route --scale-policy``: SLO-driven spawning and
  retiring of ``serve`` members.

Every module here imports no torch: the fleet layer moves frames and
files, never tensors.
"""
