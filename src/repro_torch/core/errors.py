"""Exception hierarchy for the WTF reproduction."""
from __future__ import annotations


class WtfError(Exception):
    """Base class for all WTF errors."""


class TransactionAborted(WtfError):
    """Raised to the application when a transaction hit an unresolvable,
    application-visible conflict (paper §2.6)."""


class KVConflict(WtfError):
    """Internal: optimistic validation failed inside the metadata store.

    This is the HyperDex-level abort. It is *not* surfaced to applications;
    the retry layer catches it and replays the op log (§2.6)."""


class PreconditionFailed(WtfError):
    """Internal: a commutative operation's precondition failed at commit time
    (e.g. a bounded append no longer fits in its region, §2.5)."""


class NotFound(WtfError):
    """Pathname or object does not exist."""


class AlreadyExists(WtfError):
    """Pathname already exists."""


class NotADirectory(WtfError):
    """Path component is not a directory."""


class IsADirectory(WtfError):
    """File operation attempted on a directory."""


class DirectoryNotEmpty(WtfError):
    """rmdir on a non-empty directory."""


class BadFileDescriptor(WtfError):
    """Operation on a closed or invalid fd."""


class NotOpenForWriting(BadFileDescriptor):
    """Write-side operation on an fd opened read-only (EBADF-style: POSIX
    write(2) reports EBADF for fds not open for writing)."""


class InvalidOffset(WtfError):
    """A file offset resolved to a negative position (EINVAL-style, matching
    lseek(2)/pread(2) on negative offsets)."""


class StorageError(WtfError):
    """A storage server failed to create or retrieve a slice.

    Failure-domain taxonomy (§2.9 + the repair plane) — all three subtypes
    below are ``StorageError``s, so handlers written against the generic
    data-plane failure keep working while callers that care can match the
    precise condition:

    ``StorageError``
      ├── ``DegradedRead``       read blocked by the ``min_read_replicas``
      │     │                    floor: the extent still has live replicas,
      │     │                    just fewer than the cluster requires
      │     └── ``ReplicaExhausted``
      │                          zero replicas could serve — every candidate
      │                          was dead, circuit-broken, or erroring
      └── ``DeadlineExceeded``   one replica round overran the per-round
                                 ``Cluster(io_deadline_s=...)`` budget and
                                 was abandoned (the hedge/failover walk
                                 decides what happens next)
    """


class DegradedRead(StorageError):
    """A read found fewer live replicas than ``Cluster(min_read_replicas)``
    requires.  The data is (still) readable from the surviving replicas —
    this is a policy refusal, raised so callers that demand full redundancy
    before trusting a read can tell "degraded" apart from "gone"."""


class ReplicaExhausted(DegradedRead):
    """Every replica of an extent failed to serve: the candidate walk ran
    out of live servers (§2.9).  The strongest degraded-read signal — zero
    live copies reachable right now — and what ``run_with_failover`` raises
    on exhaustion instead of a bare ``StorageError``."""


class DeadlineExceeded(StorageError):
    """A single replica round exceeded ``Cluster(io_deadline_s=...)`` and
    was abandoned.  Surfaced to the application only when every candidate
    timed out or failed; otherwise it is recorded against the slow server's
    health and the walk moves on."""


class NoQuorum(WtfError):
    """The replicated coordinator lost its quorum."""
