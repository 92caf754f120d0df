"""Pipeline DAG model: chained RunSpecs with inferred stage edges (DESIGN.md
§14; port of ``repro.core.dag``, the same edges, levels and
``pipeline_id``).

A :class:`Pipeline` is an ordered set of named stages, each a script
:class:`~.spec.RunSpec`. Edges are *inferred*, never declared: stage B
depends on stage A iff one of B's declared inputs overlaps one of A's
declared outputs, by the path semantics of the §5.5 output-conflict checks
(``conflicts.normalize``): equal paths, an input nested under an output
directory, an output nested under an input directory, or a wildcard input
whose pattern can match the output (or files inside an output directory).

Construction validates the whole DAG eagerly:

* duplicate stage names and non-dict/list shapes are rejected;
* two stages claiming the same or nested outputs is an *ambiguous
  producer* (what the job database's §5.5 check would refuse at
  submission, refused here before anything is queued);
* a stage consuming its own output is a self-cycle;
* any directed cycle among stages raises, naming the stages involved.

Per-stage resource overrides (``resources={"train": {"time_limit_s":
3600, "array_n": 4}}``) are applied via ``RunSpec.replace`` at
construction; only scheduling fields may be overridden, not the
input/output contract.

``SlurmScheduler.submit_pipeline`` consumes :meth:`Pipeline.levels` (one
``submit_many`` per topological level) and :attr:`Pipeline.parents` (the
``afterok`` edges).
"""
from __future__ import annotations

import fnmatch
import hashlib
import json
import warnings
from typing import Iterable, Mapping

from .conflicts import OutputConflict, ProtectedOutputs, has_wildcard, normalize
from .spec import RunSpec, SpecError

__all__ = ["Pipeline", "PipelineError", "PipelineWarning"]

# RunSpec fields a per-stage resource override may touch. The data contract
# (inputs/outputs/script) is identity: overriding it would silently change
# edge inference and the spec_id provenance trail.
_OVERRIDABLE = frozenset({"time_limit_s", "array_n", "env", "alt_dir", "message"})


class PipelineError(SpecError):
    """Invalid pipeline: bad shape, ambiguous producers, or cycles."""


class PipelineWarning(UserWarning):
    """Suspicious but not fatal pipeline shape (a root-level wildcard input
    that no declared stage output anchors)."""


def _static_dir(pattern: str) -> str:
    """Directory prefix of a wildcard pattern before its first wildcard:
    ``data/prep/*.npy`` -> ``data/prep``; ``*.bin`` -> ``""``."""
    idx = min(i for i, ch in enumerate(pattern) if ch in "*?[]{}")
    return pattern[:idx].rpartition("/")[0]


def _overlaps(inp: str, out: str) -> bool:
    """Does input path/pattern ``inp`` overlap declared output ``out``
    (already normalized, as RunSpec guarantees)?"""
    if has_wildcard(inp):
        # fnmatch's `*` crosses `/`, so `data/*` matches `data/a/b.npy`; a
        # pattern rooted inside an output *directory* (`prep/out/*.npy` vs.
        # output `prep/out`) overlaps it too
        if fnmatch.fnmatch(out, inp):
            return True
        static = _static_dir(inp)
        return bool(static) and (static == out or static.startswith(out + "/"))
    n = normalize(inp)
    return n == out or n.startswith(out + "/") or out.startswith(n + "/")


class Pipeline:
    """A DAG of named RunSpec stages with inferred dependency edges."""

    def __init__(
        self,
        stages: Mapping[str, RunSpec] | Iterable[RunSpec | tuple[str, RunSpec]],
        resources: Mapping[str, Mapping] | None = None,
    ) -> None:
        self.stages: dict[str, RunSpec] = self._name_stages(stages)
        self._apply_resources(resources or {})
        self.produced_by = self._check_producers()
        self.parents: dict[str, set[str]] = {n: set() for n in self.stages}
        self.children: dict[str, set[str]] = {n: set() for n in self.stages}
        self._infer_edges()
        self._levels = self._toposort()

    # -- construction ------------------------------------------------------
    @staticmethod
    def _name_stages(stages) -> dict[str, RunSpec]:
        named: dict[str, RunSpec] = {}
        if isinstance(stages, Mapping):
            items = list(stages.items())
        else:
            items = [(f"stage{i}", entry) if isinstance(entry, RunSpec) else tuple(entry)
                     for i, entry in enumerate(stages)]
        if not items:
            raise PipelineError("pipeline has no stages")
        for name, spec in items:
            if not isinstance(name, str) or not name:
                raise PipelineError(f"invalid stage name: {name!r}")
            if not isinstance(spec, RunSpec):
                raise PipelineError(f"stage {name!r} is not a RunSpec")
            if name in named:
                raise PipelineError(f"duplicate stage name: {name!r}")
            if not spec.script:
                raise PipelineError(f"stage {name!r}: pipeline stages must be script specs")
            named[name] = spec
        return named

    def _apply_resources(self, resources: Mapping[str, Mapping]) -> None:
        for name, overrides in resources.items():
            if name not in self.stages:
                raise PipelineError(f"resource override for unknown stage {name!r}")
            bad = set(overrides) - _OVERRIDABLE
            if bad:
                raise PipelineError(f"stage {name!r}: non-resource override(s) {sorted(bad)}; "
                                    f"allowed: {sorted(_OVERRIDABLE)}")
            self.stages[name] = self.stages[name].replace(**dict(overrides))

    def _check_producers(self) -> dict[str, str]:
        """Map normalized output -> producing stage; refuse two stages whose
        outputs are equal or nested (edge inference could not say which one
        an input chains from)."""
        guard = ProtectedOutputs()
        produced: dict[str, str] = {}
        for idx, (name, spec) in enumerate(self.stages.items()):
            try:
                guard.check_and_add_all(list(spec.outputs), idx)
            except OutputConflict as e:
                raise PipelineError(f"ambiguous producer: stage {name!r} outputs collide with "
                                    f"an earlier stage ({e})") from e
            for out in spec.outputs:
                produced[out] = name
        return produced

    def _infer_edges(self) -> None:
        for name, spec in self.stages.items():
            for inp in spec.inputs:
                matched = False
                for out, producer in self.produced_by.items():
                    if not _overlaps(inp, out):
                        continue
                    if producer == name:
                        raise PipelineError(f"stage {name!r} consumes its own output {out!r}")
                    matched = True
                    self.parents[name].add(producer)
                    self.children[producer].add(name)
                # a root-level wildcard (`*.npy`) has no static directory to
                # anchor against a producer's directory output (`prep`), and
                # wildcard inputs are never reported missing: the stage would
                # submit with no afterok edge and could run before its
                # producer. Guessing the edge could fabricate cycles, so warn.
                if (not matched and has_wildcard(inp) and not _static_dir(inp)
                        and any(p != name for p in self.produced_by.values())):
                    warnings.warn(
                        f"stage {name!r}: root-level wildcard input {inp!r} matches no declared stage output, "
                        "so no dependency edge was inferred; if it names files another stage writes inside an "
                        f"output directory, anchor it under that directory (e.g. '<dir>/{inp}') or the stage "
                        "may run before its producer",
                        PipelineWarning,
                        stacklevel=3,
                    )

    def _toposort(self) -> list[list[str]]:
        """Kahn level batching; leftover nodes mean a cycle."""
        indeg = {n: len(ps) for n, ps in self.parents.items()}
        frontier = [n for n in self.stages if indeg[n] == 0]
        levels: list[list[str]] = []
        seen = 0
        while frontier:
            levels.append(frontier)
            seen += len(frontier)
            nxt: list[str] = []
            for n in frontier:
                for c in sorted(self.children[n]):
                    indeg[c] -= 1
                    if indeg[c] == 0:
                        nxt.append(c)
            frontier = nxt
        if seen != len(self.stages):
            raise PipelineError(f"cycle among stages: {sorted(n for n in self.stages if indeg[n] > 0)}")
        return levels

    # -- queries -----------------------------------------------------------
    def levels(self) -> list[list[str]]:
        """Topological batches: every stage's parents are in earlier levels."""
        return [list(level) for level in self._levels]

    def edges(self) -> list[tuple[str, str]]:
        """Sorted (parent, child) pairs."""
        return sorted((p, c) for c, ps in self.parents.items() for p in ps)

    def roots(self) -> list[str]:
        return [n for n, ps in self.parents.items() if not ps]

    def upstream_outputs(self, name: str) -> set[str]:
        """All declared outputs of ``name``'s ancestors (transitive): the
        paths ``RunSpec.missing_inputs`` treats as provided at submission,
        which exist by the time the stage's afterok dependency releases it."""
        outs: set[str] = set()
        frontier = list(self.parents[name])
        seen: set[str] = set()
        while frontier:
            p = frontier.pop()
            if p in seen:
                continue
            seen.add(p)
            outs.update(self.stages[p].outputs)
            frontier.extend(self.parents[p])
        return outs

    def downstream_cone(self, name: str) -> list[str]:
        """``name`` plus every transitive descendant, in level order."""
        cone = {name}
        for level in self._levels:
            for n in level:
                if n not in cone and self.parents[n] & cone:
                    cone.add(n)
        return [n for level in self._levels for n in level if n in cone]

    @property
    def pipeline_id(self) -> str:
        """Content address of the DAG: stage spec_ids plus edges."""
        payload = {"stages": {n: s.spec_id for n, s in self.stages.items()}, "edges": self.edges()}
        return hashlib.sha256(json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()).hexdigest()

    def __len__(self) -> int:
        return len(self.stages)

    def __repr__(self) -> str:
        return f"Pipeline({len(self.stages)} stages, {len(self.edges())} edges, {len(self._levels)} levels)"
