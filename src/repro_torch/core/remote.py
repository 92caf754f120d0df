"""Remote annex tier (DESIGN.md §13; port of ``repro.core.remote``):
simulated sites over an unreliable network.

A remote site is a real annex store (its bytes are real) whose costs are
those of a link: every byte and every round trip is charged on the
repository's :class:`~.fsio.SimClock`, and every network failure is a
seeded, replayable event. Three layers:

:class:`NetProfile`
    Latency and per-direction bandwidth of one link, mapped onto an
    :class:`~.fsio.FSProfile` (``meta_op_s`` = a round trip, ``write_bw`` =
    upload, ``read_bw`` = download, per-stream caps for the stream pools).

:class:`NetworkFaultModel`
    A seeded schedule of network faults per site: transient request
    errors, stalls charged up to the link's timeout, mid-stream disconnects
    (which strand the remote-side tmp: a dead link cleans nothing up) and
    outages that take a whole site down. :func:`net_retry` retries the
    transient ones with a seeded exponential backoff charged on the clock.

:class:`RemoteStore`
    An :class:`~.annex.AnnexStore` whose FS is the link: owner-stamped tmps
    swept on open, idempotent tmp-and-rename publication, the manifest and
    chunk layout; plus one-round-trip batched presence (``has_many``),
    gated transfers with payload accounting, and an availability flag.

Transfers move chunks, not objects: :func:`push_keys` and :func:`pull_keys`
do a batched presence pass per site, journal their intent (``push`` and
``pull`` journals, nine ``remote:*`` crash points) so that a killed client
resumes sending only the missing chunks, and a pull fails over to the next
site when one dies. Modelled seconds are a model of a link, never a
measured time.
"""
from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass

from .annex import AnnexStore, encode_chunk_manifest
from .faults import InjectedNetworkError, RemoteUnavailable
from .fsio import FS, FSProfile, SimClock

# -- network profiles --------------------------------------------------------


@dataclass(frozen=True)
class NetProfile:
    """One site link: request latency + per-direction aggregate bandwidth
    (bytes/second), optional per-stream caps for §9's stream pools, a
    per-transfer stall timeout, and the server-side cost of one key probe
    inside a batched presence query."""

    name: str
    latency_s: float
    up_bw: float  # client -> remote (push), AGGREGATE across streams
    down_bw: float  # remote -> client (pull), AGGREGATE across streams
    up_stream_bw: float | None = None
    down_stream_bw: float | None = None
    timeout_s: float = 30.0
    probe_s: float = 1e-5

    def to_fs_profile(self) -> FSProfile:
        """The link as an FSProfile: every meta op is a round trip, reads
        are downloads, writes are uploads. Directory-entry degradation is
        a parallel-FS artifact, not a network one — disabled."""
        return FSProfile(
            name=f"net-{self.name}",
            meta_op_s=self.latency_s,
            read_bw=self.down_bw,
            write_bw=self.up_bw,
            degrade_threshold=0,
            dir_degrade=0.0,
            read_stream_bw=self.down_stream_bw,
            write_stream_bw=self.up_stream_bw,
        )

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "latency_s": self.latency_s,
            "up_bw": self.up_bw,
            "down_bw": self.down_bw,
            "up_stream_bw": self.up_stream_bw,
            "down_stream_bw": self.down_stream_bw,
            "timeout_s": self.timeout_s,
            "probe_s": self.probe_s,
        }

    @classmethod
    def from_json(cls, d: dict) -> "NetProfile":
        return cls(**d)


# Same machine-room: 10 GbE, sub-ms round trips.
LAN = NetProfile(name="lan", latency_s=2e-4, up_bw=1.25e9, down_bw=1.25e9)
# Cross-site archive link: ~30 ms RTT, 1 Gb/s up / 2 Gb/s down aggregate,
# one TCP stream drives a quarter of it (parallel streams pay off).
WAN = NetProfile(
    name="wan",
    latency_s=0.03,
    up_bw=1.25e8,
    down_bw=2.5e8,
    up_stream_bw=1.25e8 / 4,
    down_stream_bw=2.5e8 / 4,
    timeout_s=60.0,
)

_PRESETS = {"lan": LAN, "wan": WAN}


def coerce_net(net) -> NetProfile:
    """Accept a preset name, a config dict, a NetProfile, or None (LAN)."""
    if net is None:
        return LAN
    if isinstance(net, NetProfile):
        return net
    if isinstance(net, str):
        try:
            return _PRESETS[net]
        except KeyError:
            raise ValueError(f"unknown net profile {net!r}") from None
    if isinstance(net, dict):
        return NetProfile.from_json(net)
    raise TypeError(f"cannot build a NetProfile from {type(net).__name__}")


# -- network fault model -----------------------------------------------------


@dataclass
class NetFaultRule:
    """One declarative network fault. ``op`` is the request direction the
    rule watches: ``send`` (push-side mutation), ``recv`` (download),
    ``query`` (presence/metadata), or ``*``. ``remote`` filters by site
    name (None = any). ``kind``:

    error        transient request failure (retried with seeded backoff),
    stall        the request hangs ``stall_s`` — charged up to the
                 profile's ``timeout_s``; at/over the timeout the transfer
                 times out (transient),
    disconnect   the link dies mid-stream: fires per transferred block,
                 stranding the remote-side tmp of an in-flight upload,
    outage       the whole site goes down — every later request raises
                 :class:`~.faults.RemoteUnavailable` until it is revived.

    Triggering mirrors :class:`~.faults.FaultRule`: ``nth`` /
    ``every`` / seeded ``p`` / always, capped by ``times``."""

    op: str
    remote: str | None = None
    kind: str = "error"
    nth: int | None = None
    every: int | None = None
    p: float | None = None
    times: int | None = None
    stall_s: float = 0.0
    calls: int = 0
    fires: int = 0


class NetworkFaultModel:
    """Seeded, declarative network fault schedule shared by every
    :class:`RemoteStore` of a session. Thread-safe like
    :class:`~.faults.FaultPlan` — counters and the rng mutate
    under one lock. Also owns the retry policy: ``max_retries`` transient
    attempts per transfer, each preceded by a seeded-jitter exponential
    backoff charge (:meth:`backoff_s`) — same seed, same total charge.

    A site marked dead stays dead until :meth:`revive` (or
    :meth:`RemoteStore.mark_available`) brings it back; nothing else
    caches its death."""

    def __init__(
        self,
        seed: int = 0,
        rules: list[NetFaultRule] | tuple = (),
        max_retries: int = 4,
        backoff_base_s: float = 0.05,
    ):
        self.rng = random.Random(seed)
        self.rules = list(rules)
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self._dead: set[str] = set()
        self._lock = threading.Lock()

    # -- availability ---------------------------------------------------
    def is_available(self, remote: str) -> bool:
        with self._lock:
            return remote not in self._dead

    def mark_dead(self, remote: str) -> None:
        with self._lock:
            self._dead.add(remote)

    def revive(self, remote: str) -> None:
        """The site is back: its requests go through again."""
        with self._lock:
            self._dead.discard(remote)

    # -- retry policy ---------------------------------------------------
    def backoff_s(self, attempt: int) -> float:
        """Exponential backoff with seeded jitter in [1x, 2x) — bounded,
        deterministic per seed (the determinism test's contract)."""
        with self._lock:
            jitter = 1.0 + self.rng.random()
        return self.backoff_base_s * (2 ** attempt) * jitter

    # -- firing ---------------------------------------------------------
    def _fire(self, rule: NetFaultRule) -> bool:
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

    def _match(self, rule: NetFaultRule, op: str, remote: str) -> bool:
        if rule.op not in ("*", op):
            return False
        return rule.remote is None or rule.remote == remote

    def on_request(self, op: str, remote: str, clock: SimClock,
                   timeout_s: float) -> None:
        """Gate one remote request (before its round trip is charged)."""
        if not self.is_available(remote):
            raise RemoteUnavailable(remote)
        for rule in self.rules:
            if rule.kind == "disconnect" or not self._match(rule, op, remote):
                continue
            if not self._fire(rule):
                continue
            if rule.kind == "outage":
                self.mark_dead(remote)
                raise RemoteUnavailable(remote)
            if rule.kind == "stall":
                # the client genuinely waits — but never past its timeout
                clock.charge(min(rule.stall_s, timeout_s))
                if rule.stall_s >= timeout_s:
                    raise InjectedNetworkError(op, remote, reason="timeout")
                continue
            raise InjectedNetworkError(op, remote, reason="error")

    def on_stream(self, op: str, remote: str) -> None:
        """Mid-stream gate, consulted per transferred block: disconnects
        only — the request-level faults already fired before byte one."""
        for rule in self.rules:
            if rule.kind != "disconnect" or not self._match(rule, op, remote):
                continue
            if self._fire(rule):
                raise InjectedNetworkError(op, remote, reason="disconnect")


# -- the remote store --------------------------------------------------------


class RemoteStore(AnnexStore):
    """A simulated remote site: an annex store reached over a link.

    The backing store is real; the costs are the link's (its FS carries the
    :class:`NetProfile`). That FS's incarnation token stamps the remote-side
    tmps, so a killed client's half-uploaded objects are provably dead and
    swept when the site is opened again (``sweep_on_open``, the default).

    A site marked unavailable, by a failover or by hand, is skipped until
    :meth:`mark_available`."""

    def __init__(
        self,
        root: str,
        clock: SimClock | None = None,
        name: str = "site",
        net: "NetProfile | dict | str | None" = None,
        chunk_params=None,
        chunk_threshold: int | None = None,
        fault_model: NetworkFaultModel | None = None,
        faults=None,
        sweep_on_open: bool = True,
    ):
        self.net = coerce_net(net)
        self.fault_model = fault_model
        self._marked_dead = False
        # payload accounting, from the client's side
        self.bytes_sent = 0
        self.bytes_received = 0
        self.transfers = 0
        self.retries = 0
        fs = FS(self.net.to_fs_profile(), clock, faults=faults)
        super().__init__(root, fs, name=name, sweep_on_open=sweep_on_open, chunk_params=chunk_params,
                         chunk_threshold=chunk_threshold)

    # -- availability ---------------------------------------------------
    @property
    def available(self) -> bool:
        if self._marked_dead:
            return False
        return self.fault_model is None or self.fault_model.is_available(self.name)

    def mark_unavailable(self) -> None:
        self._marked_dead = True

    def mark_available(self) -> None:
        """Bring the site back after an outage or a failover: clear this
        store's mark and the fault model's dead entry, and forget the keys
        it was known to hold (what a site held before it went away is asked
        again, not trusted)."""
        self._marked_dead = False
        with self._known_lock:
            self._known.clear()
        if self.fault_model is not None:
            self.fault_model.revive(self.name)

    # -- fault gates ----------------------------------------------------
    def _gate(self, op: str) -> None:
        if self._marked_dead:
            raise RemoteUnavailable(self.name, "marked unavailable")
        if self.fs.faults is not None:
            # a dead client issues no requests
            self.fs.faults._check_crashed()
        if self.fault_model is not None:
            self.fault_model.on_request(op, self.name, self.fs.clock, self.net.timeout_s)

    def _gate_stream(self, op: str) -> None:
        if self.fault_model is not None:
            self.fault_model.on_stream(op, self.name)

    def _discard(self, tmp: str, e: BaseException) -> None:
        """A dead client or a dead link cleans nothing up on the site: the
        tmp stays for the sweep of the next open."""
        if getattr(e, "reason", None) != "disconnect":
            super()._discard(tmp, e)

    # -- batched presence -------------------------------------------------
    def has_many(self, keys, fresh: bool = False) -> set[str]:
        """ONE round trip for the whole batch (the site answers the probes
        at its own per-key cost), not one per key. ``fresh=True`` bypasses
        the known-key set and asks the site. The known-key set holds only
        what a live site answered; :meth:`mark_available` clears it."""
        present: set[str] = set()
        misses: list[str] = []
        for key in keys:
            if not fresh and self._is_known(key):
                present.add(key)
            else:
                misses.append(key)
        if not misses:
            return present
        self._gate("query")
        self.fs.clock.charge_meta(len(misses), self.net.latency_s + self.net.probe_s * len(misses))
        for key in misses:
            # the site's own stat: its cost is in the batch's charge above
            if os.path.exists(self._path(key)):
                present.add(key)
                self._mark_known(key)
            elif fresh:
                self._forget(key)
        return present

    # -- gated single-object operations -----------------------------------
    def has(self, key: str, fresh: bool = False) -> bool:
        if not fresh and self._is_known(key):
            return True
        self._gate("query")
        return super().has(key, fresh=fresh)

    def read(self, key: str) -> bytes:
        self._gate("recv")
        return super().read(key)

    def copy_to(self, key: str, dst: str, tmp_dir: str | None = None) -> None:
        self._gate("recv")
        super().copy_to(key, dst, tmp_dir=tmp_dir)

    def manifest_of(self, key: str) -> list[str] | None:
        self._gate("query")
        return super().manifest_of(key)

    def put_manifest(self, key: str, chunk_keys: list[str]) -> None:
        self._gate("send")
        if self.has(key):
            return
        self._publish_raw(key, encode_chunk_manifest(key, chunk_keys, self.chunk_params))

    def drop(self, key: str) -> None:
        self._gate("send")
        super().drop(key)

    # -- transfers ----------------------------------------------------------
    def receive_file(self, key: str, src_fs: FS, src_path: str) -> bool:
        """Upload one object: a charged streamed read on the client's FS and
        a charged upload through the link, checked against the key before
        the site's tmp is published. Returns False when the site holds the
        key already."""
        self._gate("send")
        if self.has(key):
            return False

        def pump(chunks):
            for c in chunks:
                self._gate_stream("send")
                self.bytes_sent += len(c)
                yield c

        with src_fs.open_read(src_path, 1 << 20) as chunks:
            self._publish_stream(pump(chunks), key, src_path)
        self.transfers += 1
        return True

    def fetch_into(self, key: str, dst: AnnexStore) -> bool:
        """Download one object into ``dst``: a charged download through the
        link and a charged write on ``dst``'s FS, checked before ``dst``'s
        tmp is published (the client cleans its tmp up after a dead link;
        only a client crash leaks it). Returns False when ``dst`` holds the
        key already."""
        self._gate("recv")
        if dst.has(key):
            return False

        def pump(chunks):
            for c in chunks:
                self._gate_stream("recv")
                self.bytes_received += len(c)
                yield c

        with self.fs.open_read(self._path(key), 1 << 20) as chunks:
            dst._publish_stream(pump(chunks), key, f"remote {self.name}'s {key}")
        self.transfers += 1
        return True


# -- bounded seeded retry ----------------------------------------------------


def net_retry(store: AnnexStore, fn, report: dict | None = None):
    """Run ``fn`` (one operation on ``store``), retrying its transient
    network faults up to the fault model's ``max_retries``, each after a
    seeded exponential backoff charged on the clock. ``RemoteUnavailable``
    and exhausted retries propagate: the caller fails over (pull) or raises
    (push). A store without a fault model is not retried."""
    model = getattr(store, "fault_model", None)
    attempt = 0
    while True:
        try:
            return fn()
        except InjectedNetworkError as e:
            if not e.transient or model is None or attempt >= model.max_retries:
                raise
            store.fs.clock.charge(model.backoff_s(attempt))
            attempt += 1
            if isinstance(store, RemoteStore):
                store.retries += 1
            if report is not None:
                report["retries"] = report.get("retries", 0) + 1


def _store_has(store: AnnexStore, keys, report: dict | None = None) -> set[str]:
    """The keys ``store`` holds by a fresh batched probe, retried."""
    return net_retry(store, lambda: store.has_many(keys, fresh=True), report)


# -- chunk-level transfers ---------------------------------------------------


def head_annex_keys(repo) -> list[str]:
    """Every annex key HEAD's tree references (what push and fetch default
    to)."""
    head = repo.head_commit()
    if head is None:
        return []
    return sorted({e["key"] for e in repo.tree_of(head).values() if e.get("t") == "annex"})


def push_keys(repo, store: AnnexStore, keys: list[str] | None = None, journal: bool = True, db=None) -> dict:
    """Resumable chunk-level push of ``keys`` (default: HEAD's annex keys)
    to one site.

    One batched fresh presence pass over the keys (objects the site holds
    never move again), then per missing key a batched pass over its chunks
    and one upload per missing chunk, the manifest bound last: the site
    never shows a manifest whose chunks it lacks. The intent is journaled
    first (kind ``push``); ``recover()`` replays a killed client's journal,
    and its presence pass sends only the chunks the site still lacks."""
    if keys is None:
        keys = head_annex_keys(repo)
    keys = list(keys)
    report = {"remote": store.name, "keys": len(keys), "keys_sent": 0, "keys_skipped": 0, "chunks_sent": 0,
              "bytes_sent": 0, "retries": 0}
    if isinstance(store, RemoteStore) and not store.available:
        raise RemoteUnavailable(store.name, "marked unavailable")
    if not keys:
        return report
    fs = repo.fs
    b0 = getattr(store, "bytes_sent", 0)
    jh = None
    if journal:
        from .recovery import JournalHandle

        jh = JournalHandle.begin(repo, "push", {"remote": store.name, "keys": keys})
        fs.crash_point("remote:push-journal-written")
    sent_any = False

    def send(key: str) -> None:
        nonlocal sent_any
        net_retry(store, lambda: store.receive_file(key, repo.annex.fs, repo.annex._path(key)), report)
        report["chunks_sent"] += 1
        if not sent_any:
            sent_any = True
            fs.crash_point("remote:push-mid-object")

    have = _store_has(store, keys, report)
    for key in keys:
        if key in have:
            report["keys_skipped"] += 1
            if jh is not None:
                jh.append({"key": key, "skipped": True})
            continue
        chunks = repo.annex.manifest_of(key) if repo.annex.chunk_aware else None
        if chunks is None:
            send(key)
        else:
            present = _store_has(store, chunks, report)
            for ck in chunks:
                if ck not in present:
                    send(ck)
                    present.add(ck)
            fs.crash_point("remote:push-before-manifest")
            net_retry(store, lambda: store.put_manifest(key, chunks), report)
        report["keys_sent"] += 1
        if jh is not None:
            jh.append({"key": key})
        fs.crash_point("remote:push-after-key")
    if jh is not None:
        jh.done()
        fs.crash_point("remote:push-done")
    report["bytes_sent"] = getattr(store, "bytes_sent", 0) - b0
    if db is not None:
        db.locations_record(store.name, keys)
    return report


def pull_keys(repo, keys: list[str] | None = None, journal: bool = True, db=None) -> dict:
    """Resumable chunk-level pull of ``keys`` (default: HEAD's annex keys)
    into the local annex, with failover between sites (:func:`fetch_one`).
    Only when no site can serve a key does the pull raise. The intent is
    journaled (kind ``pull``) for ``recover()``."""
    if keys is None:
        keys = head_annex_keys(repo)
    keys = [k for k in keys if not repo.annex.has(k)]
    report = {"keys": len(keys), "keys_fetched": 0, "chunks_fetched": 0, "bytes_received": 0, "retries": 0,
              "failovers": 0, "sources": {}}
    if not keys:
        return report
    fs = repo.fs
    candidates = list(repo._remotes)
    b0 = sum(getattr(s, "bytes_received", 0) for s in candidates)
    jh = None
    if journal:
        from .recovery import JournalHandle

        jh = JournalHandle.begin(repo, "pull", {"keys": keys})
        fs.crash_point("remote:pull-journal-written")
    fetched_any = False

    def on_fetch() -> None:
        nonlocal fetched_any
        if not fetched_any:
            fetched_any = True
            fs.crash_point("remote:pull-mid-object")

    for key in keys:
        src = fetch_one(repo, key, candidates, report, on_fetch)
        if src is None:
            raise FileNotFoundError(f"no available replica holds {key}")
        report["keys_fetched"] += 1
        report["sources"][key] = src
        if jh is not None:
            jh.append({"key": key, "from": src})
        fs.crash_point("remote:pull-after-key")
    if jh is not None:
        jh.done()
        fs.crash_point("remote:pull-done")
    report["bytes_received"] = sum(getattr(s, "bytes_received", 0) for s in candidates) - b0
    if db is not None:
        by_src: dict[str, list[str]] = {}
        for key, src in report["sources"].items():
            by_src.setdefault(src, []).append(key)
        for src, ks in by_src.items():
            db.locations_record(src, ks)
    return report


def fetch_one(repo, key: str, stores: list[AnnexStore], report: dict, on_fetch=None,
              chunked: bool = False) -> str | None:
    """Fetch ``key`` into the local annex from the first available store
    that holds it (a chunked key as a delta: only the chunks the local
    store lacks, the manifest bound last), failing over past a store that
    is down or errors past its retries: that store is marked unavailable
    (until :meth:`RemoteStore.mark_available`; the order of ``stores`` is
    the caller's, read afresh each call, so a revived site is asked in its
    place again). A chunk-aware store (any store, with ``chunked``) is asked
    for the key's manifest. ``on_fetch`` is called after each object moved.
    Returns the serving store's name; None when no store holds the key;
    raises the last error when every store that might hold it failed."""
    last_err: BaseException | None = None
    for store in stores:
        if isinstance(store, RemoteStore) and not store.available:
            continue
        try:
            if key not in _store_has(store, [key], report):
                continue  # this store never had it: not a failure
            chunks = (net_retry(store, lambda: store.manifest_of(key), report)
                      if store.chunk_aware or chunked else None)
            if chunks is None:
                net_retry(store, lambda: store.fetch_into(key, repo.annex), report)
                report["chunks_fetched"] += 1
                if on_fetch is not None:
                    on_fetch()
            else:
                local = repo.annex.has_many(chunks)
                for ck in chunks:
                    if ck in local:
                        continue
                    net_retry(store, lambda: store.fetch_into(ck, repo.annex), report)
                    local.add(ck)  # a chunk repeated in the manifest
                    report["chunks_fetched"] += 1
                    if on_fetch is not None:
                        on_fetch()
                repo.annex.put_manifest(key, chunks)
            return store.name
        except (InjectedNetworkError, RemoteUnavailable) as e:
            # this store is dead to us (outage, or its retries are spent)
            last_err = e
            if isinstance(store, RemoteStore):
                store.mark_unavailable()
            report["failovers"] += 1
    if last_err is not None:
        raise last_err
    return None
