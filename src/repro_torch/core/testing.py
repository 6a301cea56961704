"""Deterministic fault injection for tests and benchmarks.

The §2.9 replication and §2.6 transactional-retry guarantees only matter if
failures can strike *mid-operation*: between planning a batch and executing
it, between one replica's store and the next, between an op body and its
commit.  The wrappers here make those windows scriptable:

  * ``FlakyStorageServer`` proxies a real ``StorageServer`` and fails the
    Nth call of a chosen API (``create_slice``/``create_slices``/
    ``retrieve_slice``/``retrieve_slices``) with ``StorageError`` —
    transiently, or crashing
    the server for good (``crash=True``) the way a real node dies.
  * ``FlakyKV`` proxies ``WarpKV`` and fails the Nth *commit* with
    ``KVConflict``, driving the §2.6 replay layer deterministically (unlike
    ``WarpKV.inject_aborts``, which always fails the very next commits).

Both wrappers delegate everything else via ``__getattr__``, so they can be
installed in place (``cluster.servers[sid] = FlakyStorageServer(...)``,
``cluster.kv = FlakyKV(...)``) and the cluster keeps working untouched.
Counters are 1-based: ``fail_on={"create_slices": {1}}`` fails the first
call.  Clients capture ``cluster.kv`` at construction — install ``FlakyKV``
*before* creating the clients that should feel it.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Optional, Set

from .errors import KVConflict, StorageError

_FAILABLE_SERVER_OPS = ("create_slice", "create_slices", "retrieve_slice",
                        "retrieve_slices")


class FlakyStorageServer:
    """Proxy around a ``StorageServer`` that fails chosen calls by number.

    ``fail_on`` maps an op name to the set of 1-based call numbers that
    raise ``StorageError``; with ``crash=True`` the first injected failure
    also crashes the underlying server (it stays down until
    ``inner.recover()``), modelling a node death rather than a transient
    refusal.  Thread-safe: the write scheduler hits servers from a pool.

    Latency injection (deterministic, for deadline/hedge testing): with
    ``slow_every_n=k``, every k-th intercepted call sleeps ``delay_s``
    before executing — call numbering shared with ``fail_on``, so a test
    can make the SAME call slow once and fail the next time.  The sleep
    happens outside the proxy's lock (other calls proceed while one call
    is slow — and the blocking call would otherwise serialize the pool).
    """

    _LOCAL_ATTRS = frozenset(
        {"_inner", "_fail_on", "_crash", "_lock", "calls", "injected",
         "_slow_every_n", "_delay_s", "delayed"})

    def __init__(self, inner, fail_on: Dict[str, Iterable[int]],
                 crash: bool = False,
                 slow_every_n: Optional[int] = None,
                 delay_s: float = 0.0):
        if slow_every_n is not None and slow_every_n < 1:
            raise ValueError(f"slow_every_n must be >= 1, got {slow_every_n}")
        self._inner = inner
        self._fail_on: Dict[str, Set[int]] = {
            op: set(ns) for op, ns in fail_on.items()}
        for op in self._fail_on:
            if op not in _FAILABLE_SERVER_OPS:
                raise ValueError(f"cannot inject failures into {op!r}")
        self._crash = crash
        self._lock = threading.Lock()
        self._slow_every_n = slow_every_n
        self._delay_s = delay_s
        self.calls: Dict[str, int] = {op: 0 for op in _FAILABLE_SERVER_OPS}
        self.injected: int = 0
        self.delayed: int = 0

    def _maybe_fail(self, op: str) -> None:
        with self._lock:
            self.calls[op] += 1
            n = self.calls[op]
            hit = n in self._fail_on.get(op, ())
            slow = (self._slow_every_n is not None
                    and n % self._slow_every_n == 0)
            if hit:
                self.injected += 1
            if slow:
                self.delayed += 1
        if slow:
            time.sleep(self._delay_s)
        if hit:
            if self._crash:
                self._inner.crash()
            raise StorageError(
                f"injected failure: {op} call #{n} on server "
                f"{self._inner.server_id}")

    # -- intercepted API ---------------------------------------------------
    def create_slice(self, data, locality_hint=None):
        self._maybe_fail("create_slice")
        return self._inner.create_slice(data, locality_hint)

    def create_slices(self, parts, locality_hint=None):
        self._maybe_fail("create_slices")
        return self._inner.create_slices(parts, locality_hint)

    def retrieve_slice(self, ptr):
        self._maybe_fail("retrieve_slice")
        return self._inner.retrieve_slice(ptr)

    def retrieve_slices(self, ptrs):
        self._maybe_fail("retrieve_slices")
        return self._inner.retrieve_slices(ptrs)

    # -- everything else passes through ------------------------------------
    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __setattr__(self, name, value):
        # Writes to server state (e.g. ``reset_io_stats`` assigning a fresh
        # ``stats``) must land on the wrapped server, not shadow it here.
        if name in type(self)._LOCAL_ATTRS:
            object.__setattr__(self, name, value)
        else:
            setattr(self._inner, name, value)


def make_flaky_server(cluster, server_id: int,
                      fail_on: Dict[str, Iterable[int]],
                      crash: bool = False,
                      slow_every_n: Optional[int] = None,
                      delay_s: float = 0.0) -> FlakyStorageServer:
    """Wrap ``cluster.servers[server_id]`` in place; returns the wrapper."""
    flaky = FlakyStorageServer(cluster.servers[server_id], fail_on,
                               crash=crash, slow_every_n=slow_every_n,
                               delay_s=delay_s)
    cluster.servers[server_id] = flaky
    return flaky


def kill_server(cluster, server_id: int) -> None:
    """Silent node death: the server stops serving but NOTHING tells the
    coordinator — unlike ``Cluster.fail_server``, which is an orderly
    administrative removal (coordinator notified, ring refreshed).  Clients
    discover the corpse the way real ones do: failed rounds feed the
    failover walk and the health tracker's circuit breaker."""
    cluster.servers[server_id].crash()


def restart_server(cluster, server_id: int) -> None:
    """Bring a killed server back: storage recovers (slices intact — crash
    loses the process, not the disk), the coordinator re-admits it, and its
    circuit-breaker history is forgotten so it serves immediately."""
    cluster.recover_server(server_id)


class FlakyKV:
    """Proxy around ``WarpKV``/``ShardedKV`` that fails chosen commits —
    and, on a sharded KV, chosen 2PC *phases* — by number.

    ``fail_commits`` holds 1-based commit-attempt numbers (counted across
    the proxy) that raise ``KVConflict`` *before* the real commit runs —
    the filesystem is untouched, exactly the HyperDex-abort contract the
    §2.6 replay layer assumes.

    For cross-shard transactions on a ``mdshard.ShardedKV``:

      * ``fail_prepares`` — 1-based per-shard *prepare* call numbers
        (counted across the proxy) that raise ``KVConflict`` right before
        that shard validates.  Nothing has been applied anywhere yet, so
        the injected abort must leave nothing visible on ANY shard.
      * ``fail_applies`` — 1-based *commit-point* numbers (one per
        cross-shard transaction) that raise ``mdshard.PhaseCrash`` between
        prepare and apply, i.e. a coordinator crash.  ``apply_resolution``
        is what crash recovery reads from the decision record: ``"abort"``
        rolls everything back (retryable ``KVConflict``), ``"commit"``
        rolls forward and the commit completes.

    Transactions begun through the proxy route their commits here; install
    with ``cluster.kv = FlakyKV(cluster.kv)`` before creating clients.
    """

    def __init__(self, inner, fail_commits: Iterable[int] = (),
                 fail_prepares: Iterable[int] = (),
                 fail_applies: Iterable[int] = (),
                 apply_resolution: str = "abort"):
        self._inner = inner
        self._fail_commits = set(fail_commits)
        self._fail_prepares = set(fail_prepares)
        self._fail_applies = set(fail_applies)
        if apply_resolution not in ("abort", "commit"):
            raise ValueError("apply_resolution must be 'abort' or 'commit'")
        self._apply_resolution = apply_resolution
        self._lock = threading.Lock()
        self.commit_calls: int = 0
        self.prepare_calls: int = 0
        self.decide_calls: int = 0
        self.injected: int = 0

    def begin(self):
        txn = self._inner.begin()
        txn._kv = self           # commits route through _commit below
        if self._fail_prepares or self._fail_applies:
            txn._phase_hook = self._on_phase
        return txn

    def _on_phase(self, phase: str, pos: int) -> None:
        """Called by the 2PC coordinator before each shard's prepare and at
        the commit point (``decide``)."""
        if phase == "prepare":
            with self._lock:
                self.prepare_calls += 1
                hit = self.prepare_calls in self._fail_prepares
                if hit:
                    self.injected += 1
                    n = self.prepare_calls
            if hit:
                raise KVConflict(
                    f"injected prepare failure: prepare #{n} "
                    f"(shard position {pos})")
        elif phase == "decide":
            with self._lock:
                self.decide_calls += 1
                hit = self.decide_calls in self._fail_applies
                if hit:
                    self.injected += 1
            if hit:
                from .mdshard import PhaseCrash
                raise PhaseCrash(self._apply_resolution)

    def _commit(self, txn) -> None:
        with self._lock:
            self.commit_calls += 1
            hit = self.commit_calls in self._fail_commits
            if hit:
                self.injected += 1
        if hit:
            self._inner.stats.add(aborts=1)
            raise KVConflict(
                f"injected abort: commit #{self.commit_calls}")
        self._inner._commit(txn)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def make_flaky_kv(cluster, fail_commits: Iterable[int] = (),
                  fail_prepares: Iterable[int] = (),
                  fail_applies: Iterable[int] = (),
                  apply_resolution: str = "abort") -> FlakyKV:
    """Swap ``cluster.kv`` for a ``FlakyKV``; affects clients created
    AFTER this call (clients capture ``cluster.kv`` at construction)."""
    flaky = FlakyKV(cluster.kv, fail_commits, fail_prepares, fail_applies,
                    apply_resolution)
    cluster.kv = flaky
    return flaky


# ---------------------------------------------------------------------------
# Runtime lock-order witness
# ---------------------------------------------------------------------------
#
# The static pass (``python -m repro.analysis``) and this witness share one
# order declaration: ``repro.analysis.lockspec``.  Core modules wrap their
# locks with :func:`witness_lock` at construction time; when the
# ``WTF_LOCK_WITNESS`` env flag is set (``conftest.py`` sets it for the
# whole tier-1 suite), every acquisition is checked against the calling
# thread's held-lock stack and an inversion raises
# :class:`LockOrderViolation` *at acquisition time* — a clean stack trace
# pointing at both locks, instead of a 60-second deadlock timeout.  With
# the flag unset, ``witness_lock`` returns the raw lock: zero overhead in
# production and benchmarks.

import os as _os

from ..analysis import lockspec as _lockspec

_witness_tls = threading.local()


def _witness_stack():
    stack = getattr(_witness_tls, "stack", None)
    if stack is None:
        stack = _witness_tls.stack = []
    return stack


class LockOrderViolation(AssertionError):
    """A lock was acquired against the declared global order."""


class OrderedLock:
    """Wrapper enforcing ``lockspec`` rank/key order on every acquire.

    * Blocking acquires are checked *before* touching the inner lock, so a
      would-be deadlock surfaces as an exception while the thread still
      runs.
    * Re-acquiring a lock this thread already holds is allowed (RLock
      semantics) and skips the order check.
    * Same-level families declared ``multi="sorted"`` require strictly
      ascending ``key`` order — the global (shard, stripe) rule.
    * Works as the lock of a ``threading.Condition``: ``_release_save`` /
      ``_acquire_restore`` are withheld so the Condition falls back to
      plain ``release()``/``acquire()`` (which keep the stack honest), and
      ``_is_owned`` is answered from the per-thread stack.
    """

    __slots__ = ("_inner", "name", "rank", "multi", "key")

    def __init__(self, inner, level: str, key=None):
        spec = _lockspec.LEVEL_BY_NAME.get(level)
        if spec is None:
            raise ValueError(f"unknown lock level {level!r}; declare it in "
                             f"repro_torch.analysis.lockspec.LOCK_LEVELS")
        self._inner = inner
        self.name = level
        self.rank = spec.rank
        self.multi = spec.multi
        self.key = key

    def _describe(self):
        key = f"[{self.key!r}]" if self.key is not None else ""
        return f"{self.name}{key}(rank {self.rank})"

    def _check_order(self):
        stack = _witness_stack()
        for held in stack:
            if held is self:        # identity re-entry: RLock semantics
                return
        for held in stack:
            if held.rank > self.rank:
                raise LockOrderViolation(
                    f"lock-order inversion in thread "
                    f"{threading.current_thread().name!r}: acquiring "
                    f"{self._describe()} while holding {held._describe()}; "
                    f"held stack: "
                    f"{[h._describe() for h in stack]}")
            if held.rank == self.rank:
                if self.multi != "sorted":
                    raise LockOrderViolation(
                        f"two locks of level {self.name!r} (multi=none) "
                        f"held by thread "
                        f"{threading.current_thread().name!r}: "
                        f"{held._describe()} then {self._describe()}")
                if held.key is None or self.key is None \
                        or not held.key < self.key:
                    raise LockOrderViolation(
                        f"unsorted same-level acquisition of "
                        f"{self.name!r} in thread "
                        f"{threading.current_thread().name!r}: "
                        f"{held._describe()} then {self._describe()} — "
                        f"keys must be strictly ascending")

    def acquire(self, blocking=True, timeout=-1):
        if blocking:
            self._check_order()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _witness_stack().append(self)
        return ok

    def release(self):
        stack = _witness_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def _is_owned(self):
        probe = getattr(self._inner, "_is_owned", None)
        if probe is not None:
            return probe()
        return any(entry is self for entry in _witness_stack())

    def __getattr__(self, name):
        if name in ("_release_save", "_acquire_restore"):
            # Withheld on purpose: threading.Condition must go through our
            # acquire()/release() so the held stack stays balanced.
            raise AttributeError(name)
        return getattr(self._inner, name)

    def __repr__(self):
        return f"<OrderedLock {self._describe()} wrapping {self._inner!r}>"


class LockOrderWatchdog:
    """Process-wide switchboard for the runtime witness."""

    ENV_FLAG = "WTF_LOCK_WITNESS"

    @staticmethod
    def enabled() -> bool:
        return _os.environ.get(LockOrderWatchdog.ENV_FLAG, "0") \
            not in ("", "0")

    @staticmethod
    def held():
        """Snapshot of the calling thread's witnessed held-lock stack."""
        return tuple(_witness_stack())

    @staticmethod
    def assert_clean() -> None:
        stack = _witness_stack()
        if stack:
            raise LockOrderViolation(
                f"thread {threading.current_thread().name!r} still holds "
                f"witnessed locks: {[h._describe() for h in stack]}")

    @staticmethod
    def is_witnessed(lock) -> bool:
        return isinstance(lock, OrderedLock)


def witness_lock(lock, level: str, key=None, enabled=None):
    """Wrap ``lock`` as an :class:`OrderedLock` at declared ``level`` when
    the witness is on; return ``lock`` unchanged (zero overhead) when off."""
    if enabled is None:
        enabled = LockOrderWatchdog.enabled()
    if not enabled:
        return lock
    return OrderedLock(lock, level, key=key)
