"""Declarative, content-addressed job specifications (the spec layer; port
of ``repro.core.spec``, byte for byte in ``canonical_bytes`` and ``spec_id``).

A :class:`RunSpec` is the machine-actionable description of one unit of
(re-)executable work — the single source of truth that every execution path
consumes: ``Session.run``/``records.run`` (blocking execution, paper §3),
``SlurmScheduler.submit``/``submit_many`` (scheduled execution, paper §5),
``rerun`` and ``reschedule`` (re-execution from provenance). The paper's
promise is *machine-actionable* reproducibility; embedding the spec verbatim
in every provenance record (commit ``spec`` field + the RUNCMD JSON block)
means replay deserializes the exact original object instead of reassembling
keyword arguments from free text.

Three properties make that work:

1. **Frozen.** A spec is immutable after construction; derived specs are
   made with :meth:`RunSpec.replace`.
2. **Validated at construction.** The §5.2 mandatory-output rule, the §5.4
   wildcard-output rejection, output normalization, and the intra-job
   nesting check all run in ``__post_init__`` — call sites cannot forget
   them and cannot disagree about them. (Input *existence* is resolved
   against a repository root at execution time via :meth:`missing_inputs`;
   wildcard inputs are legal and expand like ``datalad run`` globs.)
3. **Content-addressed.** :meth:`canonical_bytes` is a canonical JSON form
   (sorted keys, sorted env, no whitespace), and :attr:`spec_id` is its
   sha256 — stable across field ordering, env-dict permutations, and
   list/tuple spelling, so the same spec has the same id everywhere. The
   ``message`` label is part of the spec (and so of the id); compare with
   ``spec.replace(message=...)`` when the label should not matter.

``cmd`` and ``script`` are mutually exclusive: a *command spec* (``cmd``)
is shell-executed blocking (``run``/``rerun``); a *script spec*
(``script`` [+ ``script_args``]) is submitted to the batch system
(``submit``/``reschedule``).
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from dataclasses import dataclass
from functools import cached_property

from .conflicts import (
    WildcardOutputError,
    check_intra_job,
    has_wildcard,
    normalize,
)
from .hashing import sha256_bytes

SPEC_VERSION = 1


class SpecError(ValueError):
    """A job specification is structurally invalid or cannot be executed."""


@dataclass(frozen=True)
class RunSpec:
    """One immutable, validated, content-addressed job specification."""

    cmd: str | None = None
    script: str | None = None
    script_args: str = ""
    inputs: tuple[str, ...] = ()
    outputs: tuple[str, ...] = ()
    pwd: str = "."
    alt_dir: str | None = None
    array_n: int = 1
    time_limit_s: float | None = None
    message: str = ""
    env: tuple[tuple[str, str], ...] = ()

    # ---------------------------------------------------------- validation
    def __post_init__(self) -> None:
        set_ = object.__setattr__
        if isinstance(self.inputs, str) or isinstance(self.outputs, str):
            raise SpecError(
                "inputs/outputs must be sequences of paths, not a bare string"
            )
        set_(self, "inputs", tuple(self.inputs))
        env = self.env
        if isinstance(env, dict):
            env = env.items()
        env = tuple(sorted((str(k), str(v)) for k, v in env))
        set_(self, "env", env)
        if len(dict(env)) != len(env):
            raise SpecError("duplicate keys in env")

        if (self.cmd is None) == (self.script is None):
            raise SpecError(
                "exactly one of cmd (blocking command spec) or script "
                "(batch script spec) must be set"
            )
        if self.script is not None and not self.outputs:
            raise SpecError("output specification is mandatory (paper §5.2)")
        if self.cmd is not None and self.array_n != 1:
            raise SpecError("array jobs require a script spec")
        for o in self.outputs:
            if has_wildcard(o):
                raise WildcardOutputError(o)
        normed = tuple(normalize(o) for o in self.outputs)
        check_intra_job(list(normed))
        set_(self, "outputs", normed)
        if not isinstance(self.array_n, int) or self.array_n < 1:
            raise SpecError(f"array_n must be a positive int: {self.array_n!r}")
        if self.time_limit_s is not None:
            if not self.time_limit_s > 0:
                raise SpecError(f"time_limit_s must be positive: {self.time_limit_s!r}")
            # canonical form: ints and floats must serialize identically
            set_(self, "time_limit_s", float(self.time_limit_s))
        norm_pwd = os.path.normpath(self.pwd) if self.pwd else ""
        if (
            not self.pwd
            or os.path.isabs(self.pwd)
            or norm_pwd == ".."
            or norm_pwd.startswith(".." + os.sep)
        ):
            raise SpecError(f"pwd escapes the repository: {self.pwd!r}")

    # --------------------------------------------------------- derivations
    @property
    def kind(self) -> str:
        return "cmd" if self.cmd is not None else "script"

    @property
    def record_cmd(self) -> str:
        """The command line recorded in provenance: the spec's own command
        for command specs, the submission line for script specs."""
        if self.cmd is not None:
            return self.cmd
        return f"sbatch {self.script}" + (f" {self.script_args}" if self.script_args else "")

    def title(self) -> str:
        return self.message or self.record_cmd

    def replace(self, **changes) -> "RunSpec":
        """A new validated spec with ``changes`` applied (the only way to
        'mutate' a spec)."""
        return dataclasses.replace(self, **changes)

    # ------------------------------------------------------- serialization
    def to_json(self) -> dict:
        """Plain-JSON form (lists, dict env) — embeddable in records,
        commits, and job-database rows."""
        return {
            "spec_version": SPEC_VERSION,
            "cmd": self.cmd,
            "script": self.script,
            "script_args": self.script_args,
            "inputs": list(self.inputs),
            "outputs": list(self.outputs),
            "pwd": self.pwd,
            "alt_dir": self.alt_dir,
            "array_n": self.array_n,
            "time_limit_s": self.time_limit_s,
            "message": self.message,
            "env": dict(self.env),
        }

    def canonical_bytes(self) -> bytes:
        """Canonical serialization: sorted keys, no whitespace. Two specs
        describing the same work produce identical bytes."""
        return json.dumps(self.to_json(), sort_keys=True, separators=(",", ":")).encode()

    @cached_property
    def spec_id(self) -> str:
        """Content address: sha256 of the canonical bytes."""
        return sha256_bytes(self.canonical_bytes())

    def execution_key(
        self,
        input_entries: list[tuple[str, dict]],
        env_fingerprint: str = "",
    ) -> str:
        """Content address of one *execution* of this spec: sha256 over the
        spec id, the resolved input tree (sorted ``(path, tree-entry)``
        pairs — oids/annex keys, so same paths with different content key
        differently), and an environment fingerprint. Two submissions with
        equal execution keys are guaranteed to produce the same outputs
        under the functional model, which is what licenses the §11 run
        cache to answer the second one without touching Slurm.

        The ``message`` label is part of ``spec_id`` and hence of the key —
        deliberately: a reschedule/straggler resubmit rewrites the message
        and must MISS so it really re-executes. Script *content* is keyed
        only if the script is declared as an input.
        """
        payload = {
            "spec_id": self.spec_id,
            "inputs": [
                [p, e] for p, e in sorted(input_entries, key=lambda pe: pe[0])
            ],
            "env": env_fingerprint,
        }
        return sha256_bytes(
            json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()
        )

    @classmethod
    def from_json(cls, d: dict) -> "RunSpec":
        """Reconstruct (and re-validate) a spec from its JSON form."""
        version = d.get("spec_version", SPEC_VERSION)
        if version > SPEC_VERSION:
            raise SpecError(f"spec_version {version} is newer than supported ({SPEC_VERSION})")
        return cls(
            cmd=d.get("cmd"),
            script=d.get("script"),
            script_args=d.get("script_args", ""),
            inputs=tuple(d.get("inputs", ())),
            outputs=tuple(d.get("outputs", ())),
            pwd=d.get("pwd", "."),
            alt_dir=d.get("alt_dir"),
            array_n=int(d.get("array_n", 1)),
            time_limit_s=d.get("time_limit_s"),
            message=d.get("message", ""),
            env=tuple((k, v) for k, v in d.get("env", {}).items()),
        )

    @classmethod
    def from_canonical(cls, data: bytes | str) -> "RunSpec":
        if isinstance(data, str):
            data = data.encode()
        return cls.from_json(json.loads(data))

    # ---------------------------------------------------- input resolution
    def missing_inputs(self, root: str) -> list[str]:
        """Non-wildcard inputs that do not exist under ``root``. Wildcard
        inputs are never 'missing': an empty glob is legal, like ``datalad
        run``. (The reference's ``provided`` paths, an upstream pipeline
        stage's outputs, belong to the DAG layer, ROADMAP.md §A item 2.1.)"""
        return [i for i in self.inputs if not has_wildcard(i) and not os.path.exists(os.path.join(root, i))]

    def expand_inputs(self, root: str) -> list[str]:
        """Resolve inputs against ``root``: wildcard patterns glob-expand to
        the (sorted) matching paths, literal paths pass through verbatim.
        Raises FileNotFoundError for a missing literal input."""
        out: list[str] = []
        for i in self.inputs:
            if has_wildcard(i):
                matches = sorted(glob.glob(os.path.join(root, i), recursive=True))
                out.extend(os.path.relpath(m, root) for m in matches)
            elif os.path.exists(os.path.join(root, i)):
                out.append(i)
            else:
                raise FileNotFoundError(f"input does not exist: {i}")
        return out
