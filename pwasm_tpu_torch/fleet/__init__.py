"""Fleet pieces the serve daemon needs.

Counterpart of ``pwasm_tpu/fleet/``, so far its two modules that the
daemon and the client import:

- ``transport``  — the unix-socket and TCP transport: target parsing
  and connecting shared by :class:`~pwasm_tpu_torch.service.client.
  ServiceClient` and ``serve --listen``;
- ``fencing``    — :class:`~pwasm_tpu_torch.fleet.fencing.EpochLease`,
  the member side of a fleet router's epoch lease (the ``lease-grant``
  and ``fence`` verbs).

The router, its ledger, the scaler and the standby come with a later
slice of the port.  Every module here imports no torch: the fleet
layer moves frames and files, never tensors.
"""
