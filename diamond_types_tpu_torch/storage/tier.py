"""Cold tier: one durable `PagedDocFile` home per document.

The bottom rung of the cold -> warm -> device residency ladder
(serve/README.md "Tiered residency"). Each doc's home is a single
page-store file — stream 0 holds baseline snapshots, stream 1 a WAL of
v1 patches — and `TieredStore` adds the per-doc policy the serving
tier needs on top of it:

  * `save(doc_id, oplog)` appends the oplog's unsaved suffix as one
    patch record and folds the patch chain into a fresh baseline when
    it grows past `compact_patch_records` (per-doc compaction policy);
  * `load(doc_id)` decodes the home into a FRESH OpLog the warm tier
    owns — the home file is opened per operation, so millions of docs
    never pin millions of file descriptors;
  * failure is per-doc: an unreadable home quarantines THAT doc with a
    typed `DocQuarantined` (best effort first: a rotten baseline is
    re-served from WAL replay when the patch chain still decodes), a
    slow read overrunning its hydration budget raises
    `HydrationTimeout` — neither ever poisons another doc's path.

Locking: `tier.table` (io rung) guards the lock table / quarantine map
and is never held across disk IO; `tier.doc[...]` (io rung) serializes
one doc's file operations. The serve tier's oplog guard is taken
INSIDE the doc lock around encode — the documented io -> oplog order
(analysis/rules/locks.py) — so a snapshot never races a handler
appending ops.

`StorageFaults` is the seeded fault injector the storage soak drives:
slow-disk delays on load, deterministic per seed.

The JAX package's `storage/tier.py`, copied. Its retry, timeout and
quarantine ladder is the tier's contract and touches no device.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time
from typing import Callable, Dict, Optional

from ..analysis.witness import make_lock
from ..encoding.decode import decode_into
from ..text.oplog import OpLog
from .pages import PAGE_SIZE, PagedDocFile, PagedStore
from .store import StorageError


# the tier's full counter surface, module-level so the dt-lint
# metrics-schema-drift rule (analysis/rules/metrics_schema.py) can
# cross-reference producer bumps against it without importing a class
TIER_KEYS = ("saves", "loads", "fresh_docs", "compactions",
             "salvaged_wal", "quarantines", "slow_loads")


class DocQuarantined(StorageError):
    """Typed per-doc rejection: the doc's durable home is unreadable
    (or its hydration budget is exhausted). Only THIS doc is affected
    — the rest of its bucket flushes on time."""

    def __init__(self, doc_id: str, reason: str) -> None:
        super().__init__(f"doc {doc_id!r} quarantined: {reason}")
        self.doc_id = doc_id
        self.reason = reason


class HydrationTimeout(StorageError):
    """One hydration attempt overran its per-attempt budget; the
    caller retries with backoff (transient), it does not quarantine."""

    def __init__(self, doc_id: str, budget_s: float) -> None:
        super().__init__(
            f"hydrating {doc_id!r} exceeded its {budget_s}s budget")
        self.doc_id = doc_id
        self.budget_s = budget_s


class StorageFaults:
    """Seeded fault injector for the cold tier: slow-disk delays on
    load, deterministic for a given seed so soak failures replay."""

    def __init__(self, seed: int = 0, slow_rate: float = 0.0,
                 slow_s: float = 0.05) -> None:
        self.slow_rate = float(slow_rate)
        self.slow_s = float(slow_s)
        self._rng = random.Random(f"faults:{seed}")
        self._lock = threading.Lock()
        self.injected_slow = 0

    def load_delay(self, doc_id: str) -> float:
        with self._lock:
            if self.slow_rate and self._rng.random() < self.slow_rate:
                self.injected_slow += 1
                return self.slow_s * (0.5 + self._rng.random())
            return 0.0


class TieredStore:
    """Per-doc durable homes under one root directory (see module
    docstring). Thread-safe; every public method is whole-operation
    atomic with respect to the doc it touches."""

    def __init__(self, root: str, compact_patch_records: int = 64,
                 faults: Optional[StorageFaults] = None,
                 on_persist: Optional[Callable[[str, OpLog], None]]
                 = None) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.compact_patch_records = max(int(compact_patch_records), 1)
        self.faults = faults
        # on_persist(doc_id, home_oplog) fires under the oplog guard
        # right after a save lands — the soak uses it to track each
        # doc's durable frontier for crash-recovery parity checks
        self.on_persist = on_persist
        self._tier_lock = make_lock("tier.table", "io")
        self._doc_locks: Dict[str, object] = {}
        self.quarantined: Dict[str, str] = {}
        self._counters = {k: 0 for k in TIER_KEYS}

    # ---- bookkeeping -----------------------------------------------------

    def _bump(self, key: str, n: int = 1) -> None:
        with self._tier_lock:
            self._counters[key] += n

    def counters(self) -> dict:
        with self._tier_lock:
            out = dict(self._counters)
            out["quarantined_docs"] = len(self.quarantined)
            return out

    def path(self, doc_id: str) -> str:
        return os.path.join(self.root, doc_id + ".pages")

    def _doc_lock(self, doc_id: str):
        with self._tier_lock:
            lk = self._doc_locks.get(doc_id)
            if lk is None:
                lk = self._doc_locks[doc_id] = make_lock(
                    f"tier.doc[{doc_id}]", "io")
            return lk

    # ---- quarantine ------------------------------------------------------

    def quarantine(self, doc_id: str, reason: str) -> None:
        with self._tier_lock:
            if doc_id not in self.quarantined:
                self.quarantined[doc_id] = reason
                self._counters["quarantines"] += 1

    def is_quarantined(self, doc_id: str) -> Optional[str]:
        with self._tier_lock:
            return self.quarantined.get(doc_id)

    def _reject(self, doc_id: str, reason: str) -> None:
        self.quarantine(doc_id, reason)
        raise DocQuarantined(doc_id, reason)

    # ---- save / load -----------------------------------------------------

    def save(self, doc_id: str, oplog: OpLog, oplog_lock=None) -> int:
        """Append `oplog`'s unsaved suffix to the doc's home; compact
        when the per-doc patch chain grows past the policy threshold.
        `oplog_lock` (the serve tier's oplog guard) is taken INSIDE
        the per-doc io lock — the documented io -> oplog order.
        Returns the persisted op count (len(oplog) at encode time,
        under the guard) so eviction can detect a suffix that raced
        in after the snapshot and abort instead of dropping it."""
        reason = self.is_quarantined(doc_id)
        if reason is not None:
            raise DocQuarantined(doc_id, reason)
        olock = oplog_lock if oplog_lock is not None \
            else contextlib.nullcontext()
        with self._doc_lock(doc_id):
            f = PagedDocFile(self.path(doc_id))
            try:
                with olock:
                    f.append_from(oplog)
                    persisted = len(oplog)
                    if self.on_persist is not None:
                        self.on_persist(doc_id, f.oplog)
                patches = sum(1 for _ in f.store.records(f.PATCHES))
                if patches >= self.compact_patch_records:
                    f.compact()
                    self._bump("compactions")
            finally:
                f.close()
        self._bump("saves")
        return persisted

    def load(self, doc_id: str,
             timeout_s: Optional[float] = None) -> OpLog:
        """Hydrate the doc's home into a FRESH OpLog the caller owns.
        A missing file is a brand-new doc (empty oplog), not an error.
        Raises DocQuarantined for unreadable homes (quarantining
        them), HydrationTimeout when an injected slow read overruns
        `timeout_s` (transient — the hydrator retries)."""
        reason = self.is_quarantined(doc_id)
        if reason is not None:
            raise DocQuarantined(doc_id, reason)
        if self.faults is not None:
            delay = self.faults.load_delay(doc_id)
            if delay:
                self._bump("slow_loads")
                if timeout_s is not None and delay > timeout_s:
                    time.sleep(timeout_s)
                    raise HydrationTimeout(doc_id, timeout_s)
                time.sleep(delay)
        path = self.path(doc_id)
        with self._doc_lock(doc_id):
            if not os.path.exists(path):
                self._bump("fresh_docs")
                return OpLog()
            size = os.path.getsize(path)
            try:
                st = PagedStore(path)
            except Exception as e:
                self._reject(doc_id,
                             f"unreadable: {e.__class__.__name__}")
            try:
                base = list(st.records(PagedDocFile.BASELINE))
                patches = list(st.records(PagedDocFile.PATCHES))
            finally:
                st.close()
        if not base and not patches and size >= PAGE_SIZE:
            # a non-empty home with NO decodable chain at all is
            # wipe-level corruption, not a legitimately empty doc
            self._reject(doc_id, "no_valid_pages")
        ol = OpLog()
        try:
            for rec in base:
                decode_into(ol, rec)
            for rec in patches:
                decode_into(ol, rec)
        except Exception:
            # baseline poisoned: WAL replay — the patch stream alone.
            # The first patch after a (re)created home is a full
            # encode (diff from the empty intersection), so a doc
            # whose baseline rots before its first compact replays
            # byte-identical from patches; anything less salvages the
            # longest decodable prefix or rejects typed.
            ol = OpLog()
            try:
                for rec in patches:
                    decode_into(ol, rec)
            except Exception as e:
                self._reject(doc_id,
                             f"undecodable: {e.__class__.__name__}")
            self._bump("salvaged_wal")
        self._bump("loads")
        return ol

    def compact_doc(self, doc_id: str, _crash=None) -> None:
        """Explicit compaction (the soak's crash-mid-compaction
        injection rides on `_crash` — see PagedDocFile.compact)."""
        with self._doc_lock(doc_id):
            f = PagedDocFile(self.path(doc_id))
            try:
                f.compact(_crash=_crash)
                self._bump("compactions")
            finally:
                f.close()
