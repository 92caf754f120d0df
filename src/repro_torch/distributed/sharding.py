"""Sharding rules for the production meshes (port of
``repro.distributed.sharding``), on ``DeviceMesh`` and DTensor placements.

The meshes are the reference's: ``(16,16) -> ("data","model")`` single-pod
and ``(2,16,16) -> ("pod","data","model")`` multi-pod. Data parallelism maps
to ``("pod","data")`` where a pod axis exists, tensor parallelism to
``"model"``. Rules are *logical*: model code asks for e.g. ``rules.residual``
and gets a spec valid for whichever mesh the rules were made on. Without a
mesh ``rules`` is None and every constraint is the identity.

A spec is a :class:`P`: one entry per tensor dim, each a mesh-axis name,
None, or a tuple of names for a dim split over several mesh axes, major
first. ``tuple(P(...))`` equals ``tuple(jax.sharding.PartitionSpec(...))``
for the same entries. :func:`placements` turns a spec into one DTensor
placement per mesh dim.

Baseline layout (the reference's):
  - residual stream [B, S, D]: P(dp, "model", None) — sequence parallelism
    (toggle: ``seq_shard_residual``),
  - attention/FFN weights: fused head & ff dims over "model",
  - embedding/lm_head: vocab rows local, d_model / vocab columns over "model",
  - MoE expert weights: experts over "data", ff dim over "model",
  - decode KV caches: batch over dp, head_dim over "model",
  - optimizer moments: placed exactly like their parameters.

The mesh is read through two attributes, ``mesh_dim_names`` and ``shape``
(a tuple of sizes, as ``DeviceMesh.shape`` gives it), so the rules and
``placements`` also take a stand-in that has only those two.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("pod", "data"), "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: P, mesh) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` where the mesh axis names
    tensor dim ``d`` in ``spec``, ``Replicate()`` where it names none.

    DTensor splits a dim sharded over several mesh dims in mesh-dim order,
    the first mesh dim major, as JAX does for a spec entry in mesh order. An
    entry that lists its axes in another order needs a strided shard, which
    is refused, as is an axis that the mesh lacks or that names two dims."""
    names = tuple(mesh.mesh_dim_names)
    dim_of: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec!r} names axis {a!r}, not in mesh axes {names}")
            if a in dim_of:
                raise ValueError(f"spec {spec!r} names mesh axis {a!r} twice")
            dim_of[a] = d
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec {spec!r}: the axes {axes} of dim {d} are not in mesh order {names}; "
                             "DTensor would need a strided shard")
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate() for a in names)


def distribute_local(full: torch.Tensor, mesh, place) -> DTensor:
    """A DTensor of ``full``, which every rank holds whole: each rank keeps
    its own chunk (split as ``torch.chunk`` splits, DTensor's uneven rule)
    and nothing is communicated."""
    local = full
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            parts = torch.chunk(local, mesh.size(i), dim=p.dim)
            coord = mesh.get_local_rank(i)
            local = parts[coord] if coord < len(parts) else local.narrow(p.dim, 0, 0)
    return DTensor.from_local(local.contiguous(), mesh, place, run_check=False,
                              shape=full.shape, stride=full.stride())


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axis_size(mesh, entry) -> int:
    """The number of shards a spec entry (an axis name, a tuple of names or
    None) splits a dim into on ``mesh``."""
    sizes = _sizes(mesh)
    n = 1
    for a in _axes(entry):
        n *= sizes[a]
    return n


@dataclass(frozen=True)
class ShardingRules:
    mesh: object = field(repr=False)  # a DeviceMesh, or a stand-in with mesh_dim_names and shape
    dp: tuple[str, ...] = ()  # data-parallel axes, e.g. ("pod", "data")
    tp: str | None = None  # tensor-parallel axis name
    seq_shard_residual: bool = True
    kv_shard: str = "head_dim"  # 'head_dim' | 'seq' — KV-cache tp placement
    expert_axis: str = "data"  # 'data' (ZeRO gather) | 'model' (EP all-to-all)
    fsdp: bool = False  # ZeRO-3: second weight dim over 'data' (gather at use)

    def _dp(self):
        if not self.dp:
            return None
        return self.dp if len(self.dp) > 1 else self.dp[0]

    def sharding(self, spec: P) -> tuple:
        """``(mesh, placements)`` of ``spec``: what ``distribute_tensor``
        and ``CheckpointManager.restore`` take."""
        return self.mesh, placements(spec, self.mesh)

    def constrain(self, x: torch.Tensor, spec: P) -> torch.Tensor:
        """``x`` redistributed to ``spec``; raises unless ``x`` is a DTensor."""
        if not isinstance(x, DTensor):
            raise TypeError(f"sharding rules given, but the tensor to place at {spec!r} is a plain "
                            f"{type(x).__name__} {tuple(x.shape)}, not a DTensor")
        return x.redistribute(x.device_mesh, placements(spec, self.mesh))

    # ---- activations -------------------------------------------------
    @property
    def batch(self) -> P:  # [B, S]
        return P(self._dp())

    @property
    def residual(self) -> P:  # [B, S, D]
        seq = self.tp if self.seq_shard_residual else None
        return P(self._dp(), seq, None)

    @property
    def heads(self) -> P:  # [B, S, H, Dh]
        return P(self._dp(), None, self.tp, None)

    # ---- decode-time state --------------------------------------------
    def kv_cache(self, batch_shardable: bool) -> P:
        """[B, S_cache, KV, Dh]: batch over dp when the batch is shardable;
        the tp axis on head_dim (local single-token writes) or on the
        sequence dim (local full-prefill writes)."""
        dp = self._dp() if batch_shardable else None
        if self.kv_shard == "seq":
            return P(dp, self.tp, None, None)
        return P(dp, None, None, self.tp)

    def ssm_state(self, batch_shardable: bool) -> P:
        """Leading channel-ish dim over tp: [B, H, Dh, Dh] / [B, Di, St]."""
        return P(self._dp() if batch_shardable else None, self.tp)

    # ---- params ----------------------------------------------------------
    def _fsdp_axis(self):
        return "data" if (self.fsdp and "data" in self.dp) else None

    @property
    def w_in(self) -> P:  # [D, fused_out] : fused dim over tp (+ D over data)
        return P(self._fsdp_axis(), self.tp)

    @property
    def w_out(self) -> P:  # [fused_in, D]
        return P(self.tp, self._fsdp_axis())

    def _data_size(self) -> int:
        return _sizes(self.mesh).get("data", 1) if "data" in self.dp else 1

    def w_expert_in(self, n_experts: int) -> P:  # [E, D, F]
        """expert_axis='data': experts over 'data' when the count divides,
        else d_model over 'data'. expert_axis='model': experts over the tp
        axis (expert parallelism) when the count divides it."""
        data = "data" if "data" in self.dp else None
        if self.expert_axis == "model" and self.tp:
            if n_experts % _sizes(self.mesh).get(self.tp, 1) == 0:
                return P(self.tp, data, None)
        if n_experts % max(1, self._data_size()) == 0:
            return P(data, None, self.tp)
        return P(None, data, self.tp)

    def w_expert_out(self, n_experts: int) -> P:  # [E, F, D]
        data = "data" if "data" in self.dp else None
        if self.expert_axis == "model" and self.tp:
            if n_experts % _sizes(self.mesh).get(self.tp, 1) == 0:
                return P(self.tp, None, data)
        if n_experts % max(1, self._data_size()) == 0:
            return P(data, self.tp, None)
        return P(None, self.tp, data)

    @property
    def embed(self) -> P:  # [V, D] — row-gather local, D-sharded output
        return P(self._fsdp_axis(), self.tp)

    @property
    def lm_head(self) -> P:  # [D, V] — vocab-sharded logits
        return P(self._fsdp_axis(), self.tp)

    @property
    def replicated(self) -> P:
        return P()


def make_rules(mesh, seq_shard_residual: bool = True, kv_shard: str = "head_dim",
               expert_axis: str = "data", fsdp: bool = False) -> ShardingRules | None:
    if mesh is None:
        return None
    axes = tuple(mesh.mesh_dim_names)
    dp = tuple(a for a in ("pod", "data") if a in axes)
    tp = "model" if "model" in axes else None
    return ShardingRules(mesh=mesh, dp=dp, tp=tp, seq_shard_residual=seq_shard_residual,
                         kv_shard=kv_shard, expert_axis=expert_axis, fsdp=fsdp)


def rules_for(cfg, mesh, fsdp: bool | None = None) -> ShardingRules | None:
    """``make_rules`` with the config's knobs (``seq_shard_residual``,
    ``decode_kv_shard``, ``moe_expert_axis``, ``fsdp_params``), as the
    reference's dry-run builds them; ``fsdp`` overrides the config's."""
    return make_rules(mesh, seq_shard_residual=cfg.seq_shard_residual, kv_shard=cfg.decode_kv_shard,
                      expert_axis=cfg.moe_expert_axis, fsdp=cfg.fsdp_params if fsdp is None else fsdp)


@contextlib.contextmanager
def sharded_region(rules: ShardingRules | None):
    """For a sharded run, DTensor's implicit replication: a plain tensor that
    the code builds itself (a causal mask, positions, RoPE frequencies) is
    the same on every rank and enters a DTensor op as replicated. Without
    rules, nothing. Unlike ``implicit_replication()``, which switches it
    off on leaving, a region restores what it found, so the train step's
    region (forward and backward) outlives the forward's own."""
    if rules is None:
        yield
        return
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def constrain(x, rules: ShardingRules | None, spec_name: str, *args):
    """The identity without rules; else ``x`` redistributed to the named
    rule's spec (raises unless ``x`` is a DTensor)."""
    if rules is None:
        return x
    spec = getattr(rules, spec_name)
    if callable(spec):
        spec = spec(*args)
    return rules.constrain(x, spec)
