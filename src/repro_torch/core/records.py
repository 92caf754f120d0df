"""Machine-actionable reproducibility records (paper §3, Figures 2 & 4; port
of ``repro.core.records``, the same message bytes).

A record is a structured JSON block embedded in the commit message between
sentinel lines, exactly like DataLad's ``[DATALAD RUNCMD]``:

    [REPRO RUNCMD] <human title>

    === Do not change lines below ===
    { "chain": [], "cmd": ..., "dsid": ..., "exit": 0,
      "extra_inputs": [], "inputs": [...], "outputs": [...], "pwd": ".",
      "spec": { ...RunSpec JSON... } }
    ^^^ Do not change lines above ^^^

``run`` executes a command and commits its outputs with such a record;
``rerun`` re-executes a past record and *hash-verifies* the outputs against
the recorded tree (paper §3 step 8: "based on file hashes and doesn't even
need the original outputs"). Scheduler records (Figure 4) add slurm fields.

Every execution is driven by a declarative :class:`~.spec.RunSpec`, and the
spec's JSON is embedded twice: as the ``spec`` field of the commit object
itself (so replay needs no message parsing at all) and inside the RUNCMD
block. ``rerun`` deserializes that spec verbatim (byte-identical
``spec_id``) and only falls back to reconstructing a spec from the legacy
free-text record fields for pre-spec history.
"""
from __future__ import annotations

import json
import os
import subprocess
from dataclasses import dataclass, field

from .conflicts import has_wildcard, normalize, proper_prefixes
from .repo import Repository
from .spec import RunSpec, SpecError

BEGIN = "=== Do not change lines below ==="
END = "^^^ Do not change lines above ^^^"

TITLE_RUN = "[REPRO RUNCMD]"
TITLE_SLURM = "[REPRO SLURM RUN]"


@dataclass
class RunRecord:
    cmd: str
    dsid: str
    inputs: list[str] = field(default_factory=list)
    outputs: list[str] = field(default_factory=list)
    extra_inputs: list[str] = field(default_factory=list)
    chain: list[str] = field(default_factory=list)
    exit: int | None = 0
    pwd: str = "."
    # the originating RunSpec, verbatim (None only for pre-spec history)
    spec: dict | None = None
    # slurm extension fields (paper Fig. 4); None for plain run records
    slurm_job_id: int | None = None
    slurm_outputs: list[str] | None = None
    extras: dict = field(default_factory=dict)

    @property
    def memoized(self) -> bool:
        """True for a §11 run-cache hit: no execution happened — the record
        replays an earlier run's recorded result."""
        return bool(self.extras.get("memoized"))

    @property
    def memoized_of(self) -> str | None:
        """The original run's commit oid for a memoized record, else None."""
        return self.extras.get("memoized_of")

    def to_json(self) -> dict:
        d = {
            "chain": self.chain,
            "cmd": self.cmd,
            "dsid": self.dsid,
            "exit": self.exit,
            "extra_inputs": self.extra_inputs,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "pwd": self.pwd,
        }
        if self.spec is not None:
            d["spec"] = self.spec
        if self.slurm_job_id is not None:
            d["slurm_job_id"] = self.slurm_job_id
            d["slurm_outputs"] = self.slurm_outputs or []
        d.update(self.extras)
        return d

    def to_message(self, title: str, kind: str = TITLE_RUN) -> str:
        body = json.dumps(self.to_json(), indent=1, sort_keys=True)
        return f"{kind} {title}\n\n{BEGIN}\n{body}\n{END}\n"

    @classmethod
    def from_message(cls, message: str) -> "RunRecord | None":
        if BEGIN not in message or END not in message:
            return None
        blob = message.split(BEGIN, 1)[1].split(END, 1)[0]
        d = json.loads(blob)
        known = {
            "chain", "cmd", "dsid", "exit", "extra_inputs", "inputs", "outputs",
            "pwd", "spec", "slurm_job_id", "slurm_outputs",
        }
        extras = {k: v for k, v in d.items() if k not in known}
        return cls(
            cmd=d["cmd"],
            dsid=d["dsid"],
            inputs=d.get("inputs", []),
            outputs=d.get("outputs", []),
            extra_inputs=d.get("extra_inputs", []),
            chain=d.get("chain", []),
            exit=d.get("exit"),
            pwd=d.get("pwd", "."),
            spec=d.get("spec"),
            slurm_job_id=d.get("slurm_job_id"),
            slurm_outputs=d.get("slurm_outputs"),
            extras=extras,
        )


class RunFailed(RuntimeError):
    def __init__(self, cmd: str, returncode: int, stderr: str = ""):
        super().__init__(f"command failed (exit {returncode}): {cmd}\n{stderr}")
        self.returncode = returncode


def _prepare_io(repo: Repository, spec: RunSpec) -> None:
    """Paper §3 step 1: datalad-get inputs, unlock outputs. Wildcard inputs
    glob-expand against the worktree (datalad-run semantics, matching what
    ``SlurmScheduler`` accepts); a missing literal input raises."""
    for p in spec.expand_inputs(repo.root):
        abspath = os.path.join(repo.root, p)
        if os.path.isdir(abspath):
            for dirpath, _, files in os.walk(abspath):
                for f in files:
                    repo.annex_get(os.path.relpath(os.path.join(dirpath, f), repo.root))
        else:
            repo.annex_get(p)
    for p in spec.outputs:
        repo.unlock(p)


def _execute_spec(repo: Repository, spec: RunSpec) -> None:
    """Blocking execution of a command spec from its recorded ``pwd``, with
    the spec's env overlayed. Non-zero exit raises :class:`RunFailed`."""
    if spec.cmd is None:
        raise SpecError(
            "a script spec is scheduled, not run; use SlurmScheduler.submit "
            "/ Session.submit (or reschedule for provenance replay)"
        )
    _prepare_io(repo, spec)
    workdir = os.path.join(repo.root, spec.pwd)
    env = None
    if spec.env:
        env = dict(os.environ)
        env.update(dict(spec.env))
    proc = subprocess.run(
        spec.cmd, shell=True, cwd=workdir, env=env, capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RunFailed(spec.cmd, proc.returncode, proc.stderr)


def run_spec(repo: Repository, spec: RunSpec, chain: list[str] | None = None) -> str:
    """Execute a command :class:`RunSpec` and commit outputs + record.

    The spec JSON rides along verbatim — as the commit object's ``spec``
    field and inside the RUNCMD block — so ``rerun`` reconstructs the exact
    spec (equal ``spec_id``). Returns the commit oid; a non-zero exit aborts
    without committing.
    """
    _execute_spec(repo, spec)
    spec_json = spec.to_json()
    record = RunRecord(
        cmd=spec.cmd,
        dsid=repo.dsid,
        inputs=list(spec.inputs),
        outputs=list(spec.outputs),
        chain=chain or [],
        exit=0,
        pwd=spec.pwd,
        spec=spec_json,
    )
    save_paths = list(spec.outputs) if spec.outputs else None
    return repo.save(
        paths=save_paths,
        message=record.to_message(spec.title()),
        spec=spec_json,
    )


def run(
    repo: Repository,
    cmd: str,
    inputs: list[str] | None = None,
    outputs: list[str] | None = None,
    message: str = "",
    pwd: str = ".",
    chain: list[str] | None = None,
    env: dict | None = None,
) -> str:
    """``datalad run`` equivalent — legacy keyword shim over :func:`run_spec`.

    Builds a validated :class:`RunSpec` and delegates; prefer
    ``Session.run`` / :func:`run_spec` in new code.
    """
    spec = RunSpec(
        cmd=cmd,
        inputs=tuple(inputs or ()),
        outputs=tuple(outputs or ()),
        pwd=pwd,
        message=message,
        env=tuple((env or {}).items()),
    )
    return run_spec(repo, spec, chain=chain)


def spec_of(repo: Repository, commitish: str) -> RunSpec:
    """The originating :class:`RunSpec` of a recorded commit.

    Prefers the commit object's first-class ``spec`` field (no message
    involvement at all), then the spec embedded in the RUNCMD block, and
    only for pre-spec history reconstructs an equivalent spec from the
    legacy record fields.
    """
    oid = repo.resolve(commitish)
    commit = repo.objects.get_commit(oid)
    return _spec_from_commit(oid, commit, RunRecord.from_message(commit["message"]))


def _fold_legacy_outputs(outputs: list[str]) -> tuple[str, ...]:
    """Pre-spec records were never validated, so their output lists may
    contain duplicates, entries nested under a listed directory, or even
    wildcards — all of which `RunSpec` construction rejects. Fold them into
    a spec-legal equivalent (normalize, dedup, drop nested entries, drop
    wildcards) so that history stays replayable: a directory entry's walk
    covers anything that was nested under it."""
    normed: list[str] = []
    seen: set[str] = set()
    for o in outputs:
        if has_wildcard(o):
            continue
        try:
            n = normalize(o)
        except ValueError:
            continue
        if n not in seen:
            seen.add(n)
            normed.append(n)
    return tuple(
        n for n in normed if not any(p in seen for p in proper_prefixes(n))
    )


def _spec_from_commit(oid: str, commit: dict, record: RunRecord | None) -> RunSpec:
    """Spec extraction shared by ``spec_of`` and ``rerun`` (which already
    hold the fetched commit + parsed record)."""
    spec_json = commit.get("spec")
    if spec_json is not None:
        return RunSpec.from_json(spec_json)
    if record is None:
        raise ValueError(f"commit {oid} has no reproducibility record")
    if record.spec is not None:
        return RunSpec.from_json(record.spec)
    # pre-spec history: reassemble from the record's free-form fields
    if record.slurm_job_id is not None:
        outputs = [
            o for o in record.outputs
            if o not in (record.slurm_outputs or [])
            and not os.path.basename(o).startswith(("log.slurm-", "slurm-job-"))
        ]
        return RunSpec(
            script=record.extras.get(
                "script", record.cmd.removeprefix("sbatch ").split()[0]
            ),
            script_args=record.extras.get("script_args", ""),
            inputs=tuple(record.inputs),
            outputs=_fold_legacy_outputs(outputs),
            pwd=record.pwd,
            alt_dir=record.extras.get("alt_dir"),
            array_n=int(record.extras.get("array_n", 1)),
        )
    return RunSpec(
        cmd=record.cmd,
        inputs=tuple(record.inputs),
        outputs=_fold_legacy_outputs(record.outputs),
        pwd=record.pwd,
    )


def rerun(repo: Repository, commitish: str, report_only: bool = False) -> dict:
    """``datalad rerun`` equivalent (paper §3 steps 6-8).

    Reconstructs the commit's originating :class:`RunSpec` (verbatim for
    spec-recorded history), re-executes it with the *current* inputs, then
    hash-compares the produced outputs against the recorded tree. If bitwise
    identical, no new commit is made. Returns a report dict:
    ``{"bitwise": bool, "new_commit": oid|None, "outputs": {path: same?},
    "spec_id": str}``.
    """
    oid = repo.resolve(commitish)
    commit = repo.objects.get_commit(oid)
    record = RunRecord.from_message(commit["message"])
    spec = _spec_from_commit(oid, commit, record)
    chain = (record.chain if record else []) + [oid]
    recorded_tree = repo.tree_of(oid)

    _execute_spec(repo, spec)

    # hash-verify each output against the recorded entries
    per_output: dict[str, bool] = {}
    changed = False
    for out in spec.outputs:
        abspath = os.path.join(repo.root, out)
        paths = []
        if os.path.isdir(abspath):
            for dirpath, _, files in os.walk(abspath):
                paths.extend(
                    os.path.relpath(os.path.join(dirpath, f), repo.root) for f in files
                )
        else:
            paths.append(out)
        for p in paths:
            new_entry = repo.hash_path_entry(p)  # read-only: no writes
            same = recorded_tree.get(p) == new_entry
            per_output[p] = same
            changed |= not same
    report = {
        "bitwise": not changed,
        "new_commit": None,
        "outputs": per_output,
        "spec_id": spec.spec_id,
    }
    if changed and not report_only:
        spec_json = spec.to_json()
        new_record = RunRecord(
            cmd=spec.cmd,
            dsid=repo.dsid,
            inputs=list(spec.inputs),
            outputs=list(spec.outputs),
            chain=chain,
            exit=0,
            pwd=spec.pwd,
            spec=spec_json,
        )
        report["new_commit"] = repo.save(
            paths=list(spec.outputs) or None,
            message=new_record.to_message(f"rerun of {oid[:12]}"),
            spec=spec_json,
        )
    return report
