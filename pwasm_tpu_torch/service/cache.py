"""Content-addressed result cache.

Counterpart of ``pwasm_tpu/service/cache.py``, with its names.  A
finished job's output files are stored under a **content-addressed
key**, and an identical later job (same inputs by DIGEST, same
result-affecting flags by CANONICAL FORM) is served the stored bytes
with no device, lease or queue involvement: no kernel is launched.

The key
-------

``sha256`` over a canonical JSON document of:

- the **canonicalized ref-FASTA digest** (:func:`fasta_digest`:
  per-record ``>name`` + uppercased whitespace-stripped sequence, so
  cosmetic line wrapping or case cannot split the cache);
- the **input digest** (:func:`digest_file` over the PAF bytes, or
  :func:`fasta_digest` for a ``--many2many`` target FASTA; on the
  ingest side the same pass that feeds the run,
  ``stream.pafstream.BlockLineReader``);
- the **result-affecting flag set** in canonical (sorted) form, see
  :data:`KEYED_BOOL` / :data:`KEYED_VALUE` / :data:`KEYED_FILE`: a
  cosmetic argv reorder still hits, while anything that changes output
  BYTES keys a distinct entry.  Flags that do not change bytes
  (``--device``, ``--shard``, the resilience knobs) and per-invocation
  plumbing (output PATHS, obs sinks, ``--compile-cache-dir``) are
  EXCLUDED, so the same logical job hits wherever its report lands;
- the requested **output kinds** (``o``/``s``/``w``/``ace``/``info``/
  ``cons``: kinds are keyed, paths are not).

``--batch`` is excluded too, except under ``--realign``: there each
dispatch places one band for all its lanes, so the MSA outputs depend
on the batch, and the key holds the effective ``--batch`` (absent: the
default, 256).  The reference leaves it out there as well and serves
one batch's MSA to a job of another; with that one exception, the
port's key of a job equals the reference's.

A job carrying a flag outside the table, or one whose semantics are
uncacheable (``--resume``, ``--follow``, a socket stream,
``--inject-faults``), **bypasses** the cache (:func:`classify` returns
``None``): the safe direction is always a real run.

Storage
-------

Per entry one CRC'd manifest (``<key>.json``, written through
``utils/fsio.py``'s fsync-then-replace: the COMMIT POINT) plus one
blob file per output kind (``<key>.<kind>``), each blob's size and
CRC32 recorded in the manifest.  A ``kill -9`` mid-insert leaves blobs
without a manifest: orphans that :meth:`CacheStore.sweep` removes once
they age past :data:`SWEEP_GRACE_S`; a manifest whose blob rotted is a
MISS and the entry is dropped, never a corrupt serve.

Delta entries
-------------

Report-only entries also record a **delta index**: one 16-hex digest
per input line (``<key>.dx`` sidecar, CRC'd through the manifest's
``delta`` block) plus a **family key** (:func:`family_key`: the exact
key minus the input digest).  A near-miss in the same family whose
cached input is a per-line PREFIX of the new input
(:meth:`CacheStore.delta_lookup`) serves the cached report bytes and
re-enters the run as a ``--resume`` over them, recomputing only the
last cached record and the appended tail.  ``--many2many`` entries
record per-target ``(digest, score)`` rows in the manifest (``m2m``
block), so a superset target set reuses every cached score and
dispatches only the new targets (:meth:`CacheStore.m2m_scan`).  Every
delta serve reads through the same CRC discipline as an exact hit and
is accounted FRACTIONALLY (records served / records total,
:meth:`CacheStore.note_delta`).  Eviction is LRU (manifest mtime =
last access) under ``--result-cache-max-bytes`` plus an optional TTL;
the byte accounting runs through one lock-guarded :class:`ByteLedger`
shared with the daemon's result spool.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import zlib

CACHE_KEY_VERSION = 1

# ---------------------------------------------------------------------------
# flag canonicalization table
# ---------------------------------------------------------------------------

# result-affecting booleans: present/absent changes output bytes
KEYED_BOOL = frozenset((
    "G", "F", "C", "N",            # analysis mode selection
    "realign",                     # rewrites gap structures
    "remove-cons-gaps",            # consensus refinement policy
    "no-refine-clip",              # clip refinement policy
    "skip-bad-lines",              # changes which records emit rows
    "many2many",                   # a different job type entirely
))

# result-affecting valued flags: the VALUE is keyed verbatim
KEYED_VALUE = frozenset((
    "c",                           # clipmax
    "band",                        # DP band (realign / many2many)
))

# result-affecting FILE flags: keyed by the file's content digest,
# not its path (the same motif set under a new name still hits)
KEYED_FILE = frozenset(("motifs",))

# output selectors: the KIND is keyed (an entry holds exactly the
# kinds its jobs request), the PATH is not
OUTPUT_KINDS = ("o", "s", "w", "ace", "info", "cons")

# byte-neutral or per-invocation plumbing: never part of the key
# (``batch`` is keyed under ``--realign``: :func:`classify`)
EXCLUDED = frozenset((
    "v", "D",                      # verbosity (stderr only)
    "d", "p", "m",                 # parsed-but-unread reference quirks
    "device", "batch", "shard",    # placement: bytes are parity-gated
    "max-retries", "device-deadline", "deadline-s", "fallback",
    "recover", "reprobe-interval", "reprobe-max",
    "profile", "stats", "trace-json", "log-json",
    "log-json-max-bytes", "trace-max-events", "metrics-textfile",
    "compile-cache-dir",
    "result-cache", "result-cache-max-bytes",
))

# uncacheable semantics: their presence BYPASSES the cache
BYPASS = frozenset(("resume", "follow", "inject-faults"))

# --batch's default (``core/config.py::Config.batch``): the effective
# batch of a --realign job that names none
DEFAULT_BATCH = 256


class Classified:
    """The canonical view of one job argv the key derives from."""

    __slots__ = ("flag_items", "output_kinds", "output_paths",
                 "ref_path", "input_path", "motif_path", "many2many")

    def __init__(self, flag_items, output_kinds, output_paths,
                 ref_path, input_path, motif_path, many2many):
        self.flag_items = flag_items        # sorted (flag, value) rows
        self.output_kinds = output_kinds    # sorted kind names
        self.output_paths = output_paths    # kind -> path (this job's)
        self.ref_path = ref_path
        self.input_path = input_path
        self.motif_path = motif_path
        self.many2many = many2many


def classify(opts: dict, positional: list) -> Classified | None:
    """Canonicalize a parsed argv (``cli._parse_args`` output) into
    the key's flag view, or ``None`` when the job must bypass the
    cache (bypass flag, unknown flag, stdin input, stdout report).
    Under ``--realign`` the effective ``--batch`` is keyed (absent:
    :data:`DEFAULT_BATCH`).  Pure: no file reads happen here."""
    if any(k in opts for k in BYPASS):
        return None
    flag_items: list[tuple[str, str]] = []
    output_paths: dict[str, str] = {}
    motif_path = None
    for k, v in opts.items():
        if k in EXCLUDED:
            continue
        if k in KEYED_BOOL:
            if v is True or v:          # --flag or --flag=anything
                flag_items.append((k, ""))
            continue
        if k in KEYED_VALUE:
            if v is True:
                return None             # malformed: let the run reject
            flag_items.append((k, str(v)))
            continue
        if k in KEYED_FILE:
            if v is True:
                return None
            motif_path = str(v)
            continue
        if k in OUTPUT_KINDS:
            if v is True:
                return None
            output_paths[k] = str(v)
            continue
        if k == "r":
            continue                    # keyed as the ref digest
        return None                     # unknown flag: cannot vouch
    if "o" not in output_paths:
        return None     # a stdout report has no file to serve back
    rpath = opts.get("r")
    if not isinstance(rpath, str) or not rpath:
        return None
    if len(positional) != 1 or positional[0] in ("", "-"):
        return None     # stdin (or no) input: nothing to digest
    if any(k == "realign" for k, _v in flag_items):
        # one band a dispatch: the MSA outputs depend on --batch
        batch = opts.get("batch", str(DEFAULT_BATCH))
        if batch is True or not str(batch).isascii() \
                or not str(batch).isdigit():
            return None                 # malformed: let the run reject
        flag_items.append(("batch", str(int(batch))))
    flag_items.sort()
    return Classified(
        flag_items=tuple(flag_items),
        output_kinds=tuple(sorted(output_paths)),
        output_paths=output_paths,
        ref_path=rpath,
        input_path=positional[0],
        motif_path=motif_path,
        many2many="many2many" in opts)


def classify_argv(argv: list) -> Classified | None:
    """:func:`classify` over a raw argv (the daemon's admission path
    — the argv is already cwd-absolutized there)."""
    from pwasm_tpu_torch.cli import CliError, _parse_args
    try:
        opts, positional = _parse_args(list(argv))
    except CliError:
        return None
    return classify(opts, positional)


# ---------------------------------------------------------------------------
# digests
# ---------------------------------------------------------------------------

def digest_file(path: str) -> str:
    """sha256 over a file's raw bytes in one bounded block pass.
    Deliberately NOT mmap-backed: this runs at admission inside the
    serve daemon/router on CLIENT-owned files — touching a mapped
    page past the EOF of a file truncated under us raises SIGBUS and
    kills the whole process, where a ``read`` merely sees a short
    file (the key-drift re-check at insert time catches the change
    either way).  Hashing dominates the pass, not the read."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def fasta_digest(path: str) -> str:
    """Canonicalized FASTA digest: per record, the stripped header and
    the UPPERCASED, whitespace-stripped sequence — cosmetic line
    wrapping, case, or trailing blank lines cannot split the cache,
    while any real sequence or naming change keys a distinct entry."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(b">"):
                h.update(line)
                h.update(b"\n")
            else:
                h.update(line.upper())
    return h.hexdigest()


def record_digest(name: str, seq) -> str:
    """Canonical digest of ONE FASTA record (the ``--many2many``
    per-CDS section key's query half) — same canonical form as
    :func:`fasta_digest` applied to a single record."""
    h = hashlib.sha256()
    h.update(b">" + str(name).encode("utf-8") + b"\n")
    s = seq if isinstance(seq, (bytes, bytearray)) else \
        str(seq).encode("utf-8")
    h.update(bytes(s).upper())
    return h.hexdigest()


def cache_key(ref_digest: str, input_digest: str, flag_items,
              output_kinds) -> str:
    """The content-addressed key: sha256 over the canonical JSON of
    every result-affecting fact."""
    doc = {"v": CACHE_KEY_VERSION, "ref": ref_digest,
           "input": input_digest,
           "flags": [list(fi) for fi in flag_items],
           "outputs": list(output_kinds)}
    return hashlib.sha256(json.dumps(
        doc, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


def section_key(query_digest: str, targets_digest: str,
                band: int) -> str:
    """The ``--many2many`` per-CDS SECTION key: one query record vs
    the whole target set under one band — the granularity that lets a
    job re-scoring 9 cached CDS + 1 new one dispatch only the new
    one."""
    doc = {"v": CACHE_KEY_VERSION, "m2m_section": 1,
           "q": query_digest, "targets": targets_digest,
           "band": int(band)}
    return hashlib.sha256(json.dumps(
        doc, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


def family_key(ref_digest: str, flag_items, output_kinds) -> str:
    """The delta FAMILY key: sha256 over the exact key's document
    minus the input digest.  Two runs in one family differ only by
    input CONTENT — exactly the population where a prefix-preserving
    append can be served as a delta instead of a cold run."""
    doc = {"v": CACHE_KEY_VERSION, "family": 1, "ref": ref_digest,
           "flags": [list(fi) for fi in flag_items],
           "outputs": list(output_kinds)}
    return hashlib.sha256(json.dumps(
        doc, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


def m2m_family_key(query_digest: str, band: int) -> str:
    """The ``--many2many`` delta family: one query record under one
    band, whatever the target set — superset reuse matches per-target
    digests inside the family, so the band stays keyed (a different
    band is different scores, never spliced)."""
    doc = {"v": CACHE_KEY_VERSION, "m2m_family": 1,
           "q": query_digest, "band": int(band)}
    return hashlib.sha256(json.dumps(
        doc, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


def derive_key(cls: Classified,
               input_digest: str | None = None) -> str | None:
    """Digest the classified job's inputs and derive its cache key;
    ``None`` when any input is unreadable (the run will produce the
    real diagnostic — a cache must never pre-empt it).
    ``input_digest`` skips the input re-read when the caller already
    holds it — the ingest reader's digest rides its single pass
    (``stream.pafstream.BlockLineReader``), and the insert side uses
    it both to avoid a second read and to PROVE the input did not
    change between keying and running (key mismatch = no insert)."""
    derived = derive_keys(cls, input_digest=input_digest)
    return None if derived is None else derived[0]


def derive_keys(cls: Classified,
                input_digest: str | None = None
                ) -> tuple[str, str] | None:
    """:func:`derive_key` plus the entry's delta FAMILY key, from one
    digest pass: ``(exact_key, family)`` or ``None``."""
    try:
        ref_d = fasta_digest(cls.ref_path)
        input_d = input_digest if input_digest is not None else (
            fasta_digest(cls.input_path) if cls.many2many
            else digest_file(cls.input_path))
        flag_items = list(cls.flag_items)
        if cls.motif_path is not None:
            flag_items.append(("motifs#sha256",
                               digest_file(cls.motif_path)))
            flag_items.sort()
    except OSError:
        return None
    return (cache_key(ref_d, input_d, flag_items, cls.output_kinds),
            family_key(ref_d, flag_items, cls.output_kinds))


# a delta index over a multi-million-line assembly would cost more to
# scan than the delta saves; entries past the cap still serve exact
# hits, they just never delta-match
DELTA_MAX_LINES = 100_000


def delta_eligible(cls: Classified) -> bool:
    """True when a near-miss for this job may be served as a delta:
    report-only output (the ``--resume`` fast path that makes the
    serve cheap is parse-only — MSA/summary builds need the prefix
    records re-inserted) and strict per-line replay semantics (no
    ``--skip-bad-lines``: the fast path does not re-validate the
    served prefix)."""
    return (not cls.many2many
            and cls.output_kinds == ("o",)
            and all(k != "skip-bad-lines" for k, _ in cls.flag_items))


def paf_line_digests(path: str, max_lines: int = DELTA_MAX_LINES
                     ) -> tuple[list[str] | None, str | None]:
    """The delta index column for one PAF input: one 16-hex sha256
    prefix per line (terminator-stripped, so a missing final newline
    cannot split a prefix match), plus the whole-file sha256 from the
    same pass (the caller proves the file it indexed is the file that
    ran).  ``(None, digest)`` when the file exceeds ``max_lines``;
    ``(None, None)`` when unreadable."""
    out: list[str] | None = []
    h = hashlib.sha256()
    try:
        with open(path, "rb") as f:
            for raw in f:
                h.update(raw)
                if out is not None:
                    if len(out) >= max_lines:
                        out = None
                    else:
                        out.append(hashlib.sha256(
                            raw.rstrip(b"\r\n")).hexdigest()[:16])
    except OSError:
        return None, None
    return out, h.hexdigest()


def classify_stream(opts: dict) -> Classified | None:
    """:func:`classify` for a SOCKET-fed stream job —
    same flag walk, no positional: the input arrives as frames, so its
    identity is the per-line digest column, not a file digest."""
    cls = classify(opts, ["<stream>"])
    if cls is None:
        return None
    cls.input_path = None
    return cls


def line_digest(line: str) -> str:
    """One stream line's delta-index digest — the same 16-hex column
    :func:`paf_line_digests` derives from a file, so stream and file
    entries of one family delta-match each other (terminator-stripped
    on both sides)."""
    return hashlib.sha256(
        line.rstrip("\r\n").encode("utf-8")).hexdigest()[:16]


def stream_keys(cls: Classified,
                digests: list) -> tuple[str, str] | None:
    """``(exact_key, family)`` for a stream job whose input is the
    given line-digest column.  The FAMILY is byte-identical to the
    file-side :func:`derive_keys` family for the same ref/flags/
    outputs — that shared namespace is what lets a re-opened stream
    delta-hit an entry a file run inserted, and vice versa.  The exact
    key hashes the digest column itself (there is no input file to
    digest), so stream entries still exact-collide with byte-identical
    stream replays."""
    try:
        ref_d = fasta_digest(cls.ref_path)
        flag_items = list(cls.flag_items)
        if cls.motif_path is not None:
            flag_items.append(("motifs#sha256",
                               digest_file(cls.motif_path)))
            flag_items.sort()
    except OSError:
        return None
    input_d = "stream:" + hashlib.sha256(
        "".join(digests).encode("ascii")).hexdigest()
    return (cache_key(ref_d, input_d, flag_items, cls.output_kinds),
            family_key(ref_d, flag_items, cls.output_kinds))


# ---------------------------------------------------------------------------
# the unified byte ledger (spool + cache accounting)
# ---------------------------------------------------------------------------

class ByteLedger:
    """One lock-guarded byte ledger with named accounts.  The daemon
    charges its result spool and its result cache against the SAME
    ledger, so the two byte gauges are read from one synchronized
    source and cannot drift from disk under concurrent evictions (the
    latent window the old bare ``_spool_bytes`` int left open around
    replay-time increments)."""

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


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

MANIFEST_VERSION = 1
_ACCOUNT = "cache"


class RawJSON(str):
    """A value already in canonical JSON (sorted keys, no whitespace):
    :func:`manifest_text` writes it as it is.  A ``--many2many``
    section's table of every target's (digest, score) is filled into a
    template its job shares (``stream/multicds.py::target_table``) at a
    fraction of ``json.dumps``'s cost, with the same bytes."""


def manifest_text(payload: dict) -> str:
    """A manifest's file text: ``payload`` with its ``crc`` (CRC32 of
    the payload's canonical JSON, ``utils/fsio.py::payload_crc``), in
    canonical form (sorted keys, no whitespace), the reference's bytes.
    The payload is serialized once: the members that sort before
    ``"crc"`` and those after it are two canonical objects, and the
    canonical whole is their members joined, so a ``--many2many``
    section's table of every target's score (``m2m``) is not encoded
    twice.  A :class:`RawJSON` value in a member dict stands in the
    text as it is."""
    nonce = os.urandom(8).hex()

    def members(d: dict) -> list[str]:
        # d's members in canonical JSON, without the braces, as pieces:
        # a RawJSON value leaves a string token (a random nonce no
        # payload string holds) and its text stands in the token's
        # place, never copied into a larger string.  Tokens are made in
        # sorted-key order, depth first: the order json writes them
        raws: list[str] = []

        def held(v):
            if isinstance(v, RawJSON):
                raws.append(v)
                return f"\x00{nonce}:{len(raws) - 1}\x00"
            if isinstance(v, dict):
                return {k: held(x) for k, x in sorted(v.items())}
            return v

        rest = json.dumps(held(d), sort_keys=True,
                          separators=(",", ":"))[1:-1]
        parts = []
        for k, raw in enumerate(raws):
            pre, rest = rest.split(json.dumps(f"\x00{nonce}:{k}\x00"), 1)
            parts += [pre, raw]
        return [p for p in (*parts, rest) if p]

    head = members({k: v for k, v in payload.items() if k < "crc"})
    tail = members({k: v for k, v in payload.items() if k > "crc"})
    body = [*head, ","] + tail if head and tail else head + tail
    crc = zlib.crc32(b"{")
    for part in body:
        crc = zlib.crc32(part.encode(), crc)
    crc = zlib.crc32(b"}", crc)
    return "".join(["{", *head, "," if head else "", f'"crc":{crc}',
                    "," if tail else "", *tail, "}"])


def _canonical_crc(text: str, crc: int) -> int | None:
    """CRC32 of a manifest's text with its top-level ``"crc":N`` member
    cut out: for a file written in canonical form (:func:`manifest_text`)
    that is the payload's canonical JSON, so a match verifies the
    payload without encoding it again.  None (the caller encodes) when
    the member is not found where canonical form puts it."""
    member = f'"crc":{crc}'
    at = text.find(member)
    if at < 1:
        return None
    if text[at - 1] == ",":
        cut = text[:at - 1] + text[at + len(member):]
    elif text[at + len(member)] == ",":
        cut = text[:at] + text[at + len(member) + 1:]
    else:
        cut = text[:at] + text[at + len(member):]
    return zlib.crc32(cut.encode())

# the longest the byte account goes without a recount of the directory
# while inserts add their own bytes to it (``stats_dict`` reads it so too)
RECOUNT_S = 2.0

# files younger than this are never sweep candidates: on a shared dir
# a sibling's in-flight insert is indistinguishable from a crash
# remnant until its manifest commits
SWEEP_GRACE_S = 60.0


class CacheStore:
    """Content-addressed result store (module docstring for layout and
    crash/rot semantics).  Thread-safe: admission (connection threads),
    workers (insert at finish) and eviction share one lock.

    ``metrics`` is the ``build_cache_metrics`` dict (obs/catalog.py);
    ``ledger`` the shared :class:`ByteLedger` (one is created when the
    caller has none)."""

    def __init__(self, root: str, max_bytes: int | None = None,
                 ttl_s: float | None = None, metrics: dict | None = None,
                 ledger: ByteLedger | None = None):
        self.root = root
        self.max_bytes = max_bytes
        self.ttl_s = ttl_s
        self.metrics = metrics or {}
        self.ledger = ledger if ledger is not None else ByteLedger()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.insert_errors = 0   # failed inserts (ENOSPC and kin):
        #   the job was served, only the cache write was skipped
        self.evictions = 0
        self.delta_hits = 0
        self.delta_records_served = 0
        self.delta_records_total = 0
        self._delta_fraction = 0.0   # sum of served/total per delta
        self.prefetched = 0
        self._recounted_at = 0.0     # monotonic, last disk recount
        from pwasm_tpu_torch.utils.fsio import ensure_private_dir
        ensure_private_dir(root)
        self.sweep()

    # ---- internals -----------------------------------------------------
    def _manifest_path(self, key: str) -> str:
        return os.path.join(self.root, key + ".json")

    def _blob_path(self, key: str, kind: str) -> str:
        return os.path.join(self.root, f"{key}.{kind}")

    def _read_manifest(self, key: str) -> dict | None:
        """Parse + CRC-verify one manifest; None on any defect (the
        ckpt-v2 rule: torn or rotted state is absent state)."""
        from pwasm_tpu_torch.utils.fsio import payload_crc
        try:
            with open(self._manifest_path(key),
                      encoding="utf-8") as f:
                text = f.read()
            obj = json.loads(text)
            if not isinstance(obj, dict):
                raise ValueError("not an object")
            crc = int(obj.pop("crc"))
            if _canonical_crc(text, crc) != crc \
                    and payload_crc(obj) != crc:
                raise ValueError("manifest CRC mismatch")
            if obj.get("version") != MANIFEST_VERSION \
                    or obj.get("key") != key \
                    or not isinstance(obj.get("outputs"), dict):
                raise ValueError("manifest schema mismatch")
        except (OSError, ValueError, KeyError, TypeError):
            return None
        return obj

    def _entry_bytes(self, manifest: dict) -> int:
        return int(manifest.get("bytes", 0))

    def _drop_locked(self, key: str, manifest: dict | None) -> None:
        """Unlink one entry (manifest first — later lookups miss even
        if a blob unlink fails).  The caller owes ONE
        ``_recount_locked`` after its whole drop batch — per-drop
        recounts would make eviction O(drops x dir_size) under the
        lock admission lookups need."""
        try:
            os.unlink(self._manifest_path(key))
        except OSError:
            pass
        kinds = (manifest or {}).get("outputs") or {}
        for kind in list(kinds) or list(OUTPUT_KINDS):
            try:
                os.unlink(self._blob_path(key, kind))
            except OSError:
                pass
        try:            # the delta-index sidecar dies with its entry
            os.unlink(self._blob_path(key, "dx"))
        except OSError:
            pass

    def _recount_locked(self) -> None:
        """Refresh the ledger's cache account from what is ACTUALLY on
        disk (sum of file sizes in the cache dir).  Counting from disk
        rather than incrementally is what keeps the gauge truthful on
        a SHARED cache dir, where sibling fleet members insert and
        evict under us."""
        total = 0
        try:
            for n in os.listdir(self.root):
                try:
                    total += os.path.getsize(
                        os.path.join(self.root, n))
                except OSError:
                    pass
        except OSError:
            return
        self._recounted_at = time.monotonic()
        self.ledger.set(_ACCOUNT, total)
        self._publish()

    def _publish(self) -> None:
        """Refresh the gauges from the ledger + counters."""
        m = self.metrics
        if not m:
            return
        g = m.get("bytes")
        if g is not None:
            g.set(self.ledger.value(_ACCOUNT))
        ratio = m.get("hit_ratio")
        if ratio is not None:
            total = self.hits + self.misses
            # delta serves count FRACTIONALLY (records served /
            # records total); their exact lookups already sit in the
            # miss denominator
            ratio.set(round((self.hits + self._delta_fraction)
                            / total, 6) if total else 0.0)

    def _count(self, what: str) -> None:
        setattr(self, what, getattr(self, what) + 1)
        c = self.metrics.get({"hits": "hits", "misses": "misses",
                              "insertions": "insertions",
                              "insert_errors": "insert_errors",
                              "evictions": "evictions"}[what])
        if c is not None:
            c.inc()
        self._publish()

    # ---- public API ----------------------------------------------------
    def sweep(self) -> None:
        """Startup consistency pass: remove orphan blobs (a kill -9
        landed between blob writes and the manifest commit — the
        insert never durably happened) and rebuild the ledger's byte
        account from what is actually on disk.  Only files OLDER than
        :data:`SWEEP_GRACE_S` are candidates: on a SHARED fleet dir a
        sibling process's in-flight insert looks exactly like a crash
        remnant (blobs and ``.tmp`` files, no manifest yet) and must
        never be reaped mid-write — a real crash's leavings age past
        the window and the next sweep gets them.  Manifests whose
        blobs rotted or vanished are handled LAZILY by :meth:`get`
        (drop + evict + miss), so a sweep never pays a CRC read of
        every entry."""
        with self._lock:
            try:
                names = os.listdir(self.root)
            except OSError:
                return
            now = time.time()
            manifests = {n[:-5] for n in names if n.endswith(".json")}
            for n in sorted(names):
                if n.endswith(".json"):
                    continue
                key = n.rsplit(".", 1)[0]
                if key in manifests:
                    continue
                path = os.path.join(self.root, n)
                try:
                    if now - os.path.getmtime(path) < SWEEP_GRACE_S:
                        continue     # possibly a sibling's in-flight
                        #              insert — never reap mid-write
                    os.unlink(path)
                except OSError:
                    pass
            self._recount_locked()

    def contains(self, key: str) -> bool:
        """Cheap probe (the ``cache-probe`` verb): a CRC-valid,
        unexpired manifest exists.  Blobs are verified at serve time."""
        with self._lock:
            manifest = self._read_manifest(key)
            if manifest is None:
                return False
            if self._expired(manifest):
                return False
            return True

    def _expired(self, manifest: dict) -> bool:
        if self.ttl_s is None:
            return False
        created = manifest.get("created")
        if not isinstance(created, (int, float)):
            return True
        return time.time() - created > self.ttl_s

    def _read_blobs_locked(self, key: str,
                           manifest: dict) -> dict | None:
        """Read + CRC-verify every blob of one entry; None on any
        defect (the caller owns the drop/accounting policy)."""
        blobs: dict[str, bytes] = {}
        for kind, meta in manifest["outputs"].items():
            try:
                with open(self._blob_path(key, kind), "rb") as f:
                    data = f.read()
                if len(data) != int(meta["bytes"]) \
                        or zlib.crc32(data) != int(meta["crc"]):
                    raise ValueError("blob CRC mismatch")
            except (OSError, ValueError, KeyError, TypeError):
                return None
            blobs[kind] = data
        return blobs

    def get(self, key: str) -> tuple[dict, dict] | None:
        """Serve one entry: ``(manifest, {kind: bytes})`` with every
        blob CRC-verified, or ``None`` (counted as a miss).  Any
        defect — rot, truncation, expiry — DROPS the entry: a corrupt
        entry is served exactly never."""
        with self._lock:
            manifest = self._read_manifest(key)
            if manifest is None:
                self._count("misses")
                return None
            if self._expired(manifest):
                self._drop_locked(key, manifest)
                self._recount_locked()
                self._count("evictions")
                self._count("misses")
                return None
            blobs = self._read_blobs_locked(key, manifest)
            if blobs is None:
                # rot destroys the entry: counted as an EVICTION
                # too (the metric's documented causes include CRC
                # rot — churn must be visible to cache_thrash)
                self._drop_locked(key, manifest)
                self._recount_locked()
                self._count("evictions")
                self._count("misses")
                return None
            try:
                # LRU clock: manifest mtime = last access
                os.utime(self._manifest_path(key))
            except OSError:
                pass
            self._count("hits")
            return manifest, blobs

    def delta_lookup(self, family: str, digests: list[str],
                     allow_equal: bool = False
                     ) -> tuple[str, dict, dict, int] | None:
        """Find the best delta candidate for a near-miss: a CRC-whole
        entry in the same FAMILY whose recorded input is a (strict,
        unless ``allow_equal``) per-line prefix of the new input's
        ``digests``.  Longest prefix wins — it leaves the smallest
        tail to recompute.  Returns ``(key, manifest, blobs,
        cached_lines)`` with every blob CRC-verified exactly like
        :meth:`get`, or ``None``.  A rotted delta INDEX skips the
        candidate (the entry still serves exact hits); rotted BLOBS
        drop the entry like a hit-path read would — either way the
        answer degrades to a miss, never a corrupt splice.  Does not
        count hits/misses itself: the caller's exact :meth:`get`
        already counted the miss, and :meth:`note_delta` records the
        fractional outcome."""
        if not digests:
            return None
        blob = "".join(digests).encode("ascii")
        with self._lock:
            try:
                names = os.listdir(self.root)
            except OSError:
                return None
            rows = []
            for n in sorted(names):
                if not n.endswith(".json"):
                    continue
                key = n[:-5]
                m = self._read_manifest(key)
                if m is None or self._expired(m):
                    continue
                d = m.get("delta")
                if not isinstance(d, dict) \
                        or d.get("family") != family:
                    continue
                try:
                    nl = int(d["lines"])
                    dxb, dxc = int(d["bytes"]), int(d["crc"])
                except (KeyError, ValueError, TypeError):
                    continue
                if nl < 2 or nl > len(digests) \
                        or (nl == len(digests) and not allow_equal):
                    continue
                rows.append((nl, key, m, dxb, dxc))
            rows.sort(key=lambda r: r[0], reverse=True)
            for nl, key, m, dxb, dxc in rows:
                try:
                    with open(self._blob_path(key, "dx"),
                              "rb") as f:
                        dx = f.read()
                    if len(dx) != dxb or zlib.crc32(dx) != dxc:
                        raise ValueError("delta index CRC mismatch")
                except (OSError, ValueError):
                    continue
                if dx != blob[:len(dx)]:
                    continue    # same family, not a prefix append
                blobs = self._read_blobs_locked(key, m)
                if blobs is None:
                    self._drop_locked(key, m)
                    self._recount_locked()
                    self._count("evictions")
                    continue
                try:
                    os.utime(self._manifest_path(key))
                except OSError:
                    pass
                return key, m, blobs, nl
        return None

    def delta_index(self, family: str) -> list[tuple[int, str]]:
        """Snapshot the family's delta candidates as ``(lines,
        digest_column)`` rows — the stream-delta HOLD path's in-memory
        oracle: per arriving frame it needs to know whether any
        candidate could still prefix-match once more lines arrive,
        without re-walking the store per frame.  CRC-checked dx only
        (a rotted index is simply absent from the snapshot); serving
        still goes through :meth:`delta_lookup`, which re-verifies."""
        out: list[tuple[int, str]] = []
        with self._lock:
            try:
                names = os.listdir(self.root)
            except OSError:
                return out
            for n in sorted(names):
                if not n.endswith(".json"):
                    continue
                key = n[:-5]
                m = self._read_manifest(key)
                if m is None or self._expired(m):
                    continue
                d = m.get("delta")
                if not isinstance(d, dict) \
                        or d.get("family") != family:
                    continue
                try:
                    nl = int(d["lines"])
                    dxb, dxc = int(d["bytes"]), int(d["crc"])
                    with open(self._blob_path(key, "dx"),
                              "rb") as f:
                        dx = f.read()
                    if len(dx) != dxb or zlib.crc32(dx) != dxc:
                        continue
                except (KeyError, ValueError, TypeError, OSError):
                    continue
                if nl >= 2:
                    out.append((nl, dx.decode("ascii", "replace")))
        return out

    def note_delta(self, served: int, total: int) -> None:
        """Record one completed delta serve FRACTIONALLY: a run that
        served 90 cached records of 100 moves the hit ratio by 0.9 of
        a hit, not 0 (the exact lookup already counted its miss) and
        not 1 — ``cache_thrash`` and the ``top`` CACHE row stay
        meaningful under delta traffic."""
        with self._lock:
            self.delta_hits += 1
            self.delta_records_served += max(0, int(served))
            self.delta_records_total += max(0, int(total))
            if total > 0:
                self._delta_fraction += min(
                    1.0, max(0, int(served)) / int(total))
            c = self.metrics.get("delta_hits")
            if c is not None:
                c.inc()
            self._publish()

    def m2m_scan(self) -> list[tuple[str, dict]]:
        """All CRC-valid, unexpired entries carrying an ``m2m`` score
        table — the superset-reuse candidate pool, gathered in ONE
        directory pass per ``--many2many`` job (the caller indexes by
        family)."""
        out: list[tuple[str, dict]] = []
        with self._lock:
            try:
                names = os.listdir(self.root)
            except OSError:
                return out
            for n in sorted(names):
                if not n.endswith(".json"):
                    continue
                m = self._read_manifest(n[:-5])
                if m is None or self._expired(m):
                    continue
                if isinstance(m.get("m2m"), dict):
                    out.append((n[:-5], m))
        return out

    def contains_family(self, family: str) -> bool:
        """Cheap fleet-affinity probe (the ``cache-probe`` verb's
        ``family`` field): does any CRC-valid, unexpired entry carry
        this delta (report prefix) or m2m (target subset) family?
        Manifest reads only — the member that answers true can likely
        serve the job as a DELTA at its own admission."""
        with self._lock:
            try:
                names = os.listdir(self.root)
            except OSError:
                return False
            for n in names:
                if not n.endswith(".json"):
                    continue
                m = self._read_manifest(n[:-5])
                if m is None or self._expired(m):
                    continue
                d = m.get("delta")
                if isinstance(d, dict) and d.get("family") == family:
                    return True
                d = m.get("m2m")
                if isinstance(d, dict) and d.get("family") == family:
                    return True
        return False

    def prefetch(self, max_entries: int) -> int:
        """Warm-spawn cache replication: page the HOTTEST entries
        (manifest mtime = last access, newest first) through a full
        CRC-verified read BEFORE the member takes traffic, so a
        scaler-spawned member's first repeat job serves from a warm
        page cache like a long-lived sibling's.  Non-destructive —
        a rotted entry is skipped (the serving path owns drops) —
        and locked per entry, so a concurrent admission lookup never
        waits behind the whole warm pass.  Returns entries warmed."""
        rows = []
        try:
            for n in os.listdir(self.root):
                if not n.endswith(".json"):
                    continue
                try:
                    rows.append((os.path.getmtime(
                        os.path.join(self.root, n)), n[:-5]))
                except OSError:
                    pass
        except OSError:
            return 0
        rows.sort(reverse=True)
        warmed = 0
        for _t, key in rows[:max(0, int(max_entries))]:
            with self._lock:
                m = self._read_manifest(key)
                if m is None or self._expired(m):
                    continue
                if self._read_blobs_locked(key, m) is not None:
                    warmed += 1
        with self._lock:
            self.prefetched += warmed
            self._publish()
        return warmed

    def insert(self, key: str, outputs: dict[str, bytes],
               stats: dict | None = None,
               delta: dict | None = None,
               extra: dict | None = None) -> bool:
        """Store one entry: blobs first, CRC'd manifest LAST (the
        commit point — a crash at any instant leaves either a whole
        entry or orphan blobs the next sweep removes), then enforce
        the byte budget.  Returns False on any write failure (a full
        disk costs the cache, never the job).

        ``delta`` (``{"family", "lines", "dx": bytes}``) attaches the
        per-line delta index: the ``dx`` sidecar is written with the
        blobs — BEFORE the manifest commit, so a crash can only leave
        a sidecar orphan the sweep reaps, never a manifest pointing at
        a missing index.  ``extra`` merges caller facts (the ``m2m``
        per-target score table) into the CRC'd manifest."""
        from pwasm_tpu_torch.utils.fsio import (write_durable_bytes,
                                                write_durable_text)
        meta: dict[str, dict] = {}
        total = 0
        wrote_dx = False
        with self._lock:
            # the sizes of the files this insert replaces (a re-insert)
            paths = [self._blob_path(key, k) for k in list(outputs)
                     + (["dx"] if delta is not None else [])] \
                + [self._manifest_path(key)]
            replaced = 0
            for path in paths:
                try:
                    replaced += os.path.getsize(path)
                except OSError:
                    pass
            try:
                for kind, data in outputs.items():
                    write_durable_bytes(self._blob_path(key, kind),
                                        data)
                    meta[kind] = {"bytes": len(data),
                                  "crc": zlib.crc32(data)}
                    total += len(data)
                manifest = {"version": MANIFEST_VERSION, "key": key,
                            "created": round(time.time(), 3),
                            "outputs": meta, "stats": stats,
                            "bytes": total}
                if extra:
                    manifest.update(extra)
                if delta is not None:
                    dx = delta["dx"]
                    write_durable_bytes(self._blob_path(key, "dx"),
                                        dx)
                    wrote_dx = True
                    total += len(dx)
                    manifest["bytes"] = total
                    manifest["delta"] = {
                        "family": delta["family"],
                        "lines": int(delta["lines"]),
                        "bytes": len(dx), "crc": zlib.crc32(dx)}
                text = manifest_text(manifest)
                write_durable_text(self._manifest_path(key), text)
            except OSError:
                for kind in list(meta) + (["dx"] if wrote_dx else []):
                    try:
                        os.unlink(self._blob_path(key, kind))
                    except OSError:
                        pass
                # the job was served either way: count the skipped
                # insert so a full disk is VISIBLE, never silent
                self._count("insert_errors")
                return False
            # the byte account is recounted from disk (a shared
            # directory's siblings insert and evict under us), but at
            # most every RECOUNT_S: between recounts this insert's own
            # bytes are added, less those of the files it replaced, so
            # a burst of inserts (a --many2many job's sections) lists
            # the directory once, not once an insert
            if time.monotonic() - self._recounted_at > RECOUNT_S:
                self._recount_locked()
            else:
                self.ledger.add(_ACCOUNT, total + len(text.encode("utf-8"))
                                - replaced)
            self._count("insertions")
            self._evict_locked()
        return True

    def _evict_locked(self) -> None:
        """LRU eviction to the ``max_bytes`` budget (manifest mtime =
        last access) + TTL expiry.  One ledger recount for the whole
        pass, however many entries dropped."""
        if self.max_bytes is None and self.ttl_s is None:
            return
        rows = []
        dropped = 0
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for n in sorted(names):
            if not n.endswith(".json"):
                continue
            key = n[:-5]
            manifest = self._read_manifest(key)
            if manifest is None:
                self._drop_locked(key, None)
                dropped += 1
                continue
            if self._expired(manifest):
                self._drop_locked(key, manifest)
                dropped += 1
                self._count("evictions")
                continue
            try:
                mtime = os.path.getmtime(self._manifest_path(key))
            except OSError:
                mtime = 0.0
            rows.append((mtime, key, manifest))
        if self.max_bytes is not None:
            total = sum(self._entry_bytes(m) for _t, _k, m in rows)
            rows.sort()                  # oldest access first
            for _t, key, manifest in rows:
                if total <= self.max_bytes:
                    break
                total -= self._entry_bytes(manifest)
                self._drop_locked(key, manifest)
                dropped += 1
                self._count("evictions")
        if dropped:
            self._recount_locked()

    def evict_now(self) -> None:
        """Run one eviction pass (TTL + budget) outside an insert —
        the daemon's periodic tick calls this so an idle cache still
        expires."""
        with self._lock:
            self._evict_locked()

    def stats_dict(self) -> dict:
        """The svc-stats ``cache`` block.  Bytes are recounted from
        disk (a shared dir's siblings mutate it under us) but
        TIME-GATED: a `top` refresh loop hammering the stats verb on
        a huge cache dir must not serialize every admission lookup
        behind a directory scan — between recounts the last-known
        ledger value (maintained by this process's own mutations)
        serves."""
        with self._lock:
            if time.monotonic() - self._recounted_at > RECOUNT_S:
                self._recount_locked()
            total = self.hits + self.misses
            return {
                "enabled": True,
                "dir": self.root,
                "max_bytes": self.max_bytes,
                "ttl_s": self.ttl_s,
                "hits": self.hits,
                "misses": self.misses,
                "insertions": self.insertions,
                "insert_errors": self.insert_errors,
                "evictions": self.evictions,
                "delta_hits": self.delta_hits,
                "delta_records_served": self.delta_records_served,
                "delta_records_total": self.delta_records_total,
                "prefetched": self.prefetched,
                "bytes": self.ledger.value(_ACCOUNT),
                "hit_ratio": round(
                    (self.hits + self._delta_fraction) / total, 6)
                if total else 0.0,
            }


# ---------------------------------------------------------------------------
# serving helpers (shared by the CLI and the daemon)
# ---------------------------------------------------------------------------

def insert_from_paths(store: CacheStore, key: str, cls: Classified,
                      input_digest: str | None = None,
                      stats: dict | None = None) -> bool:
    """Insert a completed run's output FILES under ``key`` — the ONE
    populate implementation every tier shares (cold CLI after
    ``_main_loop``, daemon at job finish).  The key is RE-derived
    first (``input_digest`` reuses the ingest reader's ride-along
    digest so no input re-read happens): an input rewritten while the
    run was in flight drifts the key, and inserting the new outputs
    under the OLD key would poison every future hit — skipping is
    always safe.  Best-effort: False on drift or any read failure."""
    try:
        delta = None
        if delta_eligible(cls):
            # the per-line delta index, from one extra input pass —
            # attached only when that pass reads the SAME bytes the
            # run keyed (whole-file digest match), so a mid-flight
            # rewrite can never bind a stale index to fresh outputs
            digests, fdig = paf_line_digests(cls.input_path)
            if digests is not None and len(digests) >= 2 \
                    and input_digest in (None, fdig):
                if input_digest is None:
                    input_digest = fdig
                delta = {"lines": len(digests),
                         "dx": "".join(digests).encode("ascii")}
        derived = derive_keys(cls, input_digest=input_digest)
        if derived is None or derived[0] != key:
            return False
        if delta is not None:
            delta["family"] = derived[1]
        blobs = {}
        for kind, path in cls.output_paths.items():
            with open(path, "rb") as f:
                blobs[kind] = f.read()
    except OSError:
        return False
    if isinstance(stats, dict):
        # the delta markers describe THIS run's serve, not the entry:
        # a future exact hit replaying them would claim a delta that
        # never happened
        stats = {k: v for k, v in stats.items()
                 if k not in ("cache_delta", "cache_records_served",
                              "cache_records_total")}
    else:
        stats = None
    return store.insert(key, blobs, stats=stats, delta=delta)


def serve_outputs(blobs: dict[str, bytes],
                  paths: dict[str, str]) -> bool:
    """Write the cached output bytes to this invocation's output
    paths.  All-or-nothing precheck: every requested kind must exist
    in the entry (guaranteed when the key includes the kind set, but
    verified anyway) — a partial serve would be worse than a miss."""
    if any(kind not in blobs for kind in paths):
        return False
    for kind, path in paths.items():
        with open(path, "wb") as f:
            f.write(blobs[kind])
    return True


def hit_stats(manifest: dict) -> dict:
    """The ``--stats`` JSON a cache hit serves: the original run's
    stats with ``cache_hit`` set and the backend block ZEROED — this
    serve paid no probe and touched no device, and the acceptance
    gates read exactly that."""
    st = manifest.get("stats")
    st = dict(st) if isinstance(st, dict) else {}
    st["cache_hit"] = True
    st["backend"] = {"probes": 0, "warm_hits": 0}
    return st


def argv_stats_path(argv) -> str | None:
    """The ``--stats=FILE`` path in a job argv, if any — what a hit
    still owes the caller as a file artifact."""
    return next((a.split("=", 1)[1] for a in argv
                 if isinstance(a, str) and a.startswith("--stats=")),
                None)


def write_hit_stats(manifest: dict, stats_path: str | None,
                    strict: bool = False) -> dict:
    """Serve the hit-shaped stats: returns :func:`hit_stats` and, when
    the job asked for a ``--stats`` file, writes it there too — ONE
    implementation for the serving tiers (CLI, daemon), so the
    artifact cannot drift between them.  A failed
    write is swallowed unless ``strict`` (the cold CLI raises its
    canonical diagnostic; the daemons keep serving)."""
    st = hit_stats(manifest)
    if stats_path:
        try:
            with open(stats_path, "w") as f:
                json.dump(st, f, indent=1)
                f.write("\n")
        except OSError:
            if strict:
                raise
    return st
