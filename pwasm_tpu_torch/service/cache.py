"""The result cache's byte ledger.

Counterpart of ``pwasm_tpu/service/cache.py``, so far only its
:class:`ByteLedger`, to which the serve daemon charges its result
spool.  The content-addressed result cache itself (``--result-cache``
and its delta streams) comes with a later slice of the port.
"""

from __future__ import annotations

import threading


class ByteLedger:
    """One lock-guarded byte ledger with named accounts.  The daemon
    charges its result spool (and, once ported, its result cache)
    against the SAME ledger, so the byte gauges are read from one
    synchronized source and cannot drift from disk under concurrent
    evictions."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._accounts: dict[str, int] = {}

    def add(self, account: str, n: int) -> None:
        with self._lock:
            self._accounts[account] = \
                self._accounts.get(account, 0) + int(n)

    def sub(self, account: str, n: int) -> None:
        with self._lock:
            self._accounts[account] = max(
                0, self._accounts.get(account, 0) - int(n))

    def set(self, account: str, n: int) -> None:
        with self._lock:
            self._accounts[account] = max(0, int(n))

    def value(self, account: str) -> int:
        with self._lock:
            return self._accounts.get(account, 0)
