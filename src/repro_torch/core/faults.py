"""Deterministic fault injection (DESIGN.md §10; port of the crash and Slurm
half of ``repro.core.faults``).

Recovery (:mod:`.recovery`) is only believable if it survives what real HPC
does to a process: ``sacct``/``sbatch`` fail under controller load, nodes
die (NODE_FAIL), jobs are preempted, and the finish process itself is killed
mid-batch. This module makes each of those a seeded, replayable event, so
that for every named crash point "kill here, then recover" can be tested.

A :class:`FaultPlan` holds :class:`FaultRule`\\ s on the Slurm interface
("sacct fails twice, then succeeds", "the 2nd task started dies with
NODE_FAIL") and a ``crash_at`` map of named crash points
("finish:after-publish" -> crash on the 1st hit). The plan is carried by a
:class:`~.repo.Repository` and the :class:`~.slurm.LocalSlurmCluster`; the
scheduler, the annex and the checkpoint manager mark their phase boundaries
with ``repo.crash_point(name)``. Rules on the filesystem ("EIO on every
50th read", "fail the 3rd rename under objects/", a torn write) are checked
by :class:`~.fsio.FS` before each operation; a transient one is retried
there with a backoff charged on the simulated clock. The network's faults
(:class:`InjectedNetworkError`, :class:`RemoteUnavailable`) are raised by
:class:`~.remote.NetworkFaultModel`.

Crash semantics
---------------
A fired crash point (or a Slurm rule with ``error="crash"``) raises
:class:`CrashInjected`, a ``BaseException``, and flips the plan into the
*crashed* state: every later hook of the plan raises ``CrashInjected`` too
(each filesystem operation of an FS that carries the plan among them),
and the incarnation tokens of every repository the plan is attached to die.
The port's writers check their token before each effect (``files``,
``locks``, the journals), so the dying incarnation writes, unlinks, releases
and closes nothing more: its tmp files and lock files stay behind, as a
killed process's would. Cleanup handlers re-raise via :func:`is_crash`
before cleaning up.

Liveness tokens
---------------
"Is the owner of this lock / tmp file still alive?" is normally a pid probe,
but a simulated crash happens inside a live process. Every repository
therefore carries an incarnation ``token`` registered in a process-wide live
set, and :func:`owner_is_dead` answers for a dead pid, a dead incarnation of
this process, and a live owner alike.
"""
from __future__ import annotations

import fnmatch
import os
import random
import threading
import uuid
from dataclasses import dataclass

# -- liveness token registry -------------------------------------------------

_TOKEN_LOCK = threading.Lock()
_LIVE_TOKENS: set[str] = set()


def new_token() -> str:
    """Mint and register a live incarnation token (one per repository)."""
    token = uuid.uuid4().hex[:12]
    with _TOKEN_LOCK:
        _LIVE_TOKENS.add(token)
    return token


def kill_token(token: str | None) -> None:
    with _TOKEN_LOCK:
        _LIVE_TOKENS.discard(token)


def is_live(token: str | None) -> bool:
    """False only for a token this process minted and a crash killed (or
    one it never minted); None, the token of an unstamped writer, is live."""
    if token is None:
        return True
    with _TOKEN_LOCK:
        return token in _LIVE_TOKENS


def ensure_live(token: str | None) -> None:
    """Raise :class:`CrashInjected` if ``token``'s incarnation is dead: a
    killed process has no further effects."""
    if not is_live(token):
        raise CrashInjected(f"incarnation {token} is dead")


def _pid_alive(pid) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    except (OverflowError, ValueError, TypeError):
        return False
    return True


def owner_is_dead(pid, token=None) -> bool:
    """Is the (pid, token) that stamped a lock or tmp file provably dead?

    Dead iff the pid no longer exists, or the pid is *this* process and the
    token is not in the live set (a simulated crash killed it). A live
    foreign pid is never declared dead here; the lock's heartbeat TTL is
    the caller's cross-host fallback. Each package keeps its own live set,
    so in one process the other package's incarnations count as dead: a
    sweep never runs beside the other package's writes in this process."""
    if pid is None:
        return False
    if not _pid_alive(pid):
        return True
    if pid == os.getpid() and token is not None:
        return not is_live(token)
    return False


# -- exceptions --------------------------------------------------------------


class CrashInjected(BaseException):
    """A simulated hard process kill (kill -9 / NODE_FAIL of the client).

    A ``BaseException``, so ``except Exception`` never turns a simulated
    death into a handled error; cleanup handlers that catch
    ``BaseException`` re-raise via :func:`is_crash`."""


class InjectedIOError(IOError):
    """A filesystem fault from a :class:`FaultRule` (modelled EIO)."""

    def __init__(self, op: str, path: str, transient: bool = False):
        super().__init__(5, f"injected {'transient ' if transient else ''}EIO during {op} of {path}")
        self.op = op
        self.path = path
        self.transient = transient


class InjectedSlurmError(RuntimeError):
    """A Slurm CLI fault (sbatch/sacct failing under controller load)."""

    def __init__(self, op: str, transient: bool = False):
        super().__init__(f"injected {'transient ' if transient else ''}slurm failure in {op}")
        self.op = op
        self.transient = transient


class InjectedNetworkError(IOError):
    """A network fault from a :class:`~.remote.NetworkFaultModel`.

    ``reason`` is ``error`` (a request failed), ``timeout`` (a stall passed
    the transfer's timeout) or ``disconnect`` (the link died mid-stream: the
    remote-side tmp of the transfer is stranded for the owner-stamped
    sweep). All three are transient: the bounded retry may issue the
    transfer again."""

    def __init__(self, op: str, remote: str, reason: str = "error", transient: bool = True):
        super().__init__(5, f"injected network {reason} during {op} on remote {remote!r}")
        self.op = op
        self.remote = remote
        self.reason = reason
        self.transient = transient


class RemoteUnavailable(RuntimeError):
    """A whole site is down, not one request: not transient. The caller
    marks the store unavailable and fails over to the next replica, or
    raises where the site was the one asked for."""

    def __init__(self, remote: str, why: str = "outage"):
        super().__init__(f"remote {remote!r} unavailable ({why})")
        self.remote = remote
        self.transient = False


def is_crash(exc: BaseException) -> bool:
    return isinstance(exc, CrashInjected)


def is_transient(exc: BaseException) -> bool:
    return bool(getattr(exc, "transient", False))


# -- rules & plan ------------------------------------------------------------


@dataclass
class FaultRule:
    """One declarative fault. ``op`` is the injection site:

    filesystem  ``read | write | write-chunk | rename | unlink | listdir |
                stat | exists`` (``write-chunk`` fires mid-stream inside
                ``FS.write_chunks``: a torn write),
    slurm       ``sbatch | sacct | scancel | scontrol``,
    tasks       ``task``: ``error`` names the injected terminal state
                (``NODE_FAIL``, ``PREEMPTED``, ``TIMEOUT``, ``FAILED``).

    Triggering: ``nth`` fires on exactly the nth matching call; ``every``
    on each k-th; ``p`` with seeded probability; none of the three = every
    matching call. ``times`` caps the total fires. ``path`` is a substring
    (or fnmatch glob) filter on the touched path. ``error`` is ``"io"``
    (default: an :class:`InjectedIOError` or :class:`InjectedSlurmError`),
    ``"crash"``, or a task state name."""

    op: str
    path: str | None = None
    nth: int | None = None
    every: int | None = None
    p: float | None = None
    times: int | None = None
    error: str = "io"
    transient: bool = False
    calls: int = 0
    fires: int = 0

    def _matches_path(self, path: str | None) -> bool:
        if self.path is None:
            return True
        if path is None:
            return False
        if any(c in self.path for c in "*?["):
            return fnmatch.fnmatch(path, self.path)
        return self.path in path


class FaultPlan:
    """Seeded, declarative fault schedule shared by the repository's
    filesystem, the cluster and the scheduler.

    Thread-safe: counters mutate under one lock. ``record_points=True``
    turns the plan into a crash-point recorder: a clean run logs every
    boundary it passes in ``crash_point_log``, which is how the crash-matrix
    tests check that every named point is on the path they kill.

    ``max_fs_retries`` and ``max_slurm_retries`` bound the transient faults
    the filesystem and the scheduler's Slurm calls retry before one
    propagates; each retry is charged ``backoff_base_s`` doubled per
    attempt on the simulated clock."""

    def __init__(
        self,
        seed: int = 0,
        rules: list[FaultRule] | tuple = (),
        crash_at: dict[str, int] | None = None,
        record_points: bool = False,
        max_fs_retries: int = 4,
        max_slurm_retries: int = 4,
        backoff_base_s: float = 0.05,
    ):
        self.rng = random.Random(seed)
        self.rules = list(rules)
        self.crash_at = dict(crash_at or {})
        self.record_points = record_points
        self.max_fs_retries = max_fs_retries
        self.max_slurm_retries = max_slurm_retries
        self.backoff_base_s = backoff_base_s
        self.crashed = False
        self.crash_origin: str | None = None
        self.crash_point_log: list[str] = []
        self._point_hits: dict[str, int] = {}
        self._attached: list = []
        self._lock = threading.Lock()

    # -- wiring ---------------------------------------------------------
    def attach_fs(self, owner) -> None:
        """Tie ``owner``'s incarnation (its ``token``: an :class:`~.fsio.FS`
        and the repository over it share one) to this plan: a crash kills
        it."""
        with self._lock:
            self._attached.append(owner)

    def backoff_s(self, attempt: int) -> float:
        """The backoff charged before transient retry ``attempt``."""
        return self.backoff_base_s * (2 ** attempt)

    # -- firing ---------------------------------------------------------
    def _check_crashed(self) -> None:
        if self.crashed:
            raise CrashInjected(self.crash_origin or "process already crashed")

    def _fire(self, rule: FaultRule) -> bool:
        """Count one matching call; decide (under the lock) whether the
        rule fires on it."""
        with self._lock:
            rule.calls += 1
            if rule.times is not None and rule.fires >= rule.times:
                return False
            if rule.nth is not None:
                fire = rule.calls == rule.nth
            elif rule.every is not None:
                fire = rule.calls % rule.every == 0
            elif rule.p is not None:
                fire = self.rng.random() < rule.p
            else:
                fire = True
            if fire:
                rule.fires += 1
            return fire

    def _do_crash(self, origin: str) -> None:
        with self._lock:
            self.crashed = True
            self.crash_origin = origin
            dead = list(self._attached)
        for owner in dead:
            kill_token(getattr(owner, "token", None))
        raise CrashInjected(origin)

    def on_fs(self, op: str, path: str, fs=None) -> None:
        """Filesystem hook, called by :class:`~.fsio.FS` before the
        operation runs."""
        del fs  # the reference's signature; the plan needs no more than the path
        self._check_crashed()
        for rule in self.rules:
            if rule.op != op or not rule._matches_path(path):
                continue
            if self._fire(rule):
                if rule.error == "crash":
                    self._do_crash(f"{op}:{path}")
                raise InjectedIOError(op, path, transient=rule.transient)

    def on_slurm(self, op: str) -> None:
        """Slurm CLI injection hook (sbatch/sacct/scancel/scontrol)."""
        self._check_crashed()
        for rule in self.rules:
            if rule.op != op:
                continue
            if self._fire(rule):
                if rule.error == "crash":
                    self._do_crash(f"slurm:{op}")
                raise InjectedSlurmError(op, transient=rule.transient)

    def task_fate(self) -> str | None:
        """Forced terminal state for the task now starting (rules with
        ``op="task"``; ``error`` is the state name), or None to run it."""
        self._check_crashed()
        for rule in self.rules:
            if rule.op != "task":
                continue
            if self._fire(rule):
                return rule.error
        return None

    def crash_point(self, name: str) -> None:
        """A named phase boundary. Crashes when ``crash_at[name]`` hits are
        reached; always appended to the log when recording."""
        self._check_crashed()
        with self._lock:
            hits = self._point_hits.get(name, 0) + 1
            self._point_hits[name] = hits
            if self.record_points:
                self.crash_point_log.append(name)
        want = self.crash_at.get(name)
        if want is not None and hits == want:
            self._do_crash(name)
