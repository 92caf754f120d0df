"""Machine-actionable run records in commit messages (port of
``repro.core.records.RunRecord`` and of the JSON form of
``repro.core.spec.RunSpec``).

A record is a JSON block between sentinel lines of the commit message::

    [REPRO RUNCMD] <title>

    === Do not change lines below ===
    { "chain": [], "cmd": ..., "dsid": ..., ... }
    ^^^ Do not change lines above ^^^
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

BEGIN = "=== Do not change lines below ==="
END = "^^^ Do not change lines above ^^^"

TITLE_RUN = "[REPRO RUNCMD]"

SPEC_VERSION = 1

_KNOWN = {"chain", "cmd", "dsid", "exit", "extra_inputs", "inputs", "outputs", "pwd", "spec",
          "slurm_job_id", "slurm_outputs"}


def command_spec_json(cmd: str, outputs: list[str]) -> dict:
    """``RunSpec(cmd=cmd, outputs=outputs).to_json()`` for a command spec
    with every other field at its default; ``outputs`` must already be
    normalised repo-relative paths."""
    return {
        "spec_version": SPEC_VERSION,
        "cmd": cmd,
        "script": None,
        "script_args": "",
        "inputs": [],
        "outputs": list(outputs),
        "pwd": ".",
        "alt_dir": None,
        "array_n": 1,
        "time_limit_s": None,
        "message": "",
        "env": {},
    }


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
    spec: dict | None = None
    slurm_job_id: int | None = None
    slurm_outputs: list[str] | None = None
    extras: dict = field(default_factory=dict)

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
        d = json.loads(message.split(BEGIN, 1)[1].split(END, 1)[0])
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
            extras={k: v for k, v in d.items() if k not in _KNOWN},
        )
