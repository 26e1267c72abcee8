"""Bounded CUDA probing.

Counterpart of ``pwasm_tpu/utils/backend.py`` on CUDA.  A wedged card
hangs the first call that creates a CUDA context, so the CLI's
``--device=cuda`` path probes through this module first: a subprocess
creates a context and runs one reduction on the card, bounded by a
timeout (``PWASM_DEVICE_PROBE_TIMEOUT``, default 150 s), so a dead card
costs seconds, not a hang.  The healthy verdict is cached per process
and across processes (a TTL marker in a per-uid 0700 directory of the
temp dir, ``PWASM_DEVICE_PROBE_TTL`` seconds, default 300);
``PWASM_DEVICE_PROBE=0`` skips the probe.
"""

from __future__ import annotations

import os
import stat as _stat
import subprocess
import sys

_probe_cache: tuple[float, str | None, str] | None = None  # (ts, platform, why)

# process-wide probe accounting: "probes" counts subprocess probes
# actually paid (a torch import and a CUDA context each), "warm_hits"
# checks answered from warm state instead (a context this process
# already holds, the in-process TTL cache, or the cross-process TTL
# marker).  The CLI diffs them around its startup gate into the run's
# --stats "backend" block.
probe_counters = {"probes": 0, "warm_hits": 0}

_PROBE_CODE = ("import torch; n = torch.cuda.device_count(); "
               "torch.zeros(1, device='cuda').sum().item(); "
               "print('PLATFORM=cuda:%d' % n)")


def probe_timeout() -> float:
    """The probe's bound in seconds (``PWASM_DEVICE_PROBE_TIMEOUT``)."""
    try:
        return float(os.environ.get("PWASM_DEVICE_PROBE_TIMEOUT", "150"))
    except ValueError:
        return 150.0


def probe_backend(env: dict, timeout: float) -> tuple[str | None, str]:
    """Ask a subprocess whether a CUDA context comes up under ``env``
    and a kernel runs on it.  Returns ``("cuda", "")`` on success, or
    ``(None, diagnostic)`` on an error OR a hang."""
    probe_counters["probes"] += 1
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE_CODE], env=env,
                           capture_output=True, timeout=timeout,
                           text=True)
    except subprocess.TimeoutExpired:
        return None, f"probe hang (> {timeout:.0f}s)"
    except Exception as e:
        return None, f"probe spawn failed: {type(e).__name__}: {e}"
    if r.returncode != 0:
        return None, r.stderr[-500:]
    for line in r.stdout.splitlines():
        if line.startswith("PLATFORM="):
            return line.split("=", 1)[1].split(":")[0], ""
    return None, r.stderr[-500:]


def _marker_uid() -> int:
    """The uid the marker directory is keyed on AND verified against."""
    return os.getuid() if hasattr(os, "getuid") else 0


def _success_marker() -> str | None:
    """Path of the cross-process probe-success marker, keyed on the env
    that selects the cards (two shells that see different cards must
    not share a verdict).  It lives in a per-uid 0700 subdirectory of
    the temp dir, so no other local user can plant or squat the name.
    None when the directory cannot be created or trusted (no cache;
    probes still work)."""
    import hashlib
    import tempfile

    d = os.path.join(tempfile.gettempdir(),
                     f"pwasm_torch_probe_{_marker_uid()}")
    try:
        os.makedirs(d, mode=0o700, exist_ok=True)
        st = os.lstat(d)
        if not _stat.S_ISDIR(st.st_mode) or st.st_uid != _marker_uid():
            return None     # squatted by another user: no cache
        if st.st_mode & 0o077:
            # makedirs does not tighten a directory that already exists
            os.chmod(d, 0o700)
    except OSError:
        return None
    key = "|".join(os.environ.get(k, "") for k in
                   ("CUDA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER",
                    "NVIDIA_VISIBLE_DEVICES"))
    h = hashlib.sha256(key.encode()).hexdigest()[:16]
    return os.path.join(d, f"ok_{h}")


def _backend_already_initialized() -> bool:
    """True only when this process already holds a CUDA context (a mere
    ``import torch`` creates none and proves nothing about the card)."""
    if "torch" not in sys.modules:
        return False
    import torch

    return torch.cuda.is_initialized()


def invalidate_probe_cache() -> None:
    """Drop every cached healthy verdict, the in-process one AND the
    cross-process marker: called when the breaker confirms a dead card
    mid-run, so no process inherits a stale "healthy"."""
    global _probe_cache
    _probe_cache = None
    marker = _success_marker()
    if marker is not None:
        try:
            os.unlink(marker)
        except OSError:
            pass


def device_backend_reachable() -> tuple[bool, str]:
    """Bounded health check before the CLI's first CUDA context.

    Returns ``(True, "")`` when a context comes up and a kernel runs,
    or ``(False, diagnostic)``.  The healthy verdict is cached per
    process and across processes through the TTL marker, so
    consecutive healthy runs probe once, not every run.  True without
    a probe when this process already holds a context, or when
    ``PWASM_DEVICE_PROBE=0``."""
    global _probe_cache
    import time

    if os.environ.get("PWASM_DEVICE_PROBE", "1") == "0":
        return True, ""     # probing disabled: neither paid nor warm
    if _backend_already_initialized():
        probe_counters["warm_hits"] += 1
        return True, ""
    try:
        ttl = float(os.environ.get("PWASM_DEVICE_PROBE_TTL", "300"))
    except ValueError:
        ttl = 300.0
    now = time.time()
    paid = False
    if _probe_cache is None or (ttl > 0 and now - _probe_cache[0] > ttl):
        marker = _success_marker()
        if marker is not None:
            try:
                # the 0700 directory already excludes other users; the
                # lstat + regular-file + uid check is belt and braces,
                # and anything unexpected is removed and re-probed
                st = os.lstat(marker)
                if (_stat.S_ISREG(st.st_mode)
                        and st.st_uid == _marker_uid()):
                    if ttl > 0 and now - st.st_mtime < ttl:
                        _probe_cache = (now, "cached", "")
                        probe_counters["warm_hits"] += 1
                        return True, ""
                else:
                    try:
                        if _stat.S_ISDIR(st.st_mode):
                            os.rmdir(marker)
                        else:
                            os.unlink(marker)
                    except OSError:
                        pass
            except OSError:
                pass
        platform, why = probe_backend(dict(os.environ), probe_timeout())
        paid = True
        _probe_cache = (now, platform, why)
        if platform is not None and marker is not None:
            try:  # refresh the marker, never through a symlink
                fd = os.open(marker,
                             os.O_WRONLY | os.O_CREAT | os.O_TRUNC
                             | getattr(os, "O_NOFOLLOW", 0), 0o600)
                os.close(fd)
                os.utime(marker, None)
            except OSError:
                pass
    _ts, platform, why = _probe_cache
    if platform is not None and not paid:
        probe_counters["warm_hits"] += 1
    return platform is not None, why
