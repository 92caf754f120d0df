"""The parts of ``repro.core`` that later slices of the port add, by the
ROADMAP.md item that queues each, and the error their entry points raise
until then."""
from __future__ import annotations

DAG = "ROADMAP.md §A item 2.1, the DAG layer"
RECOVERY = "ROADMAP.md §A item 2.2, recovery"
REMOTES = "ROADMAP.md §A item 2.3, remote tiers"
PACKS = "ROADMAP.md §A item 2.4, pack writing and gc"
COST_MODEL = "ROADMAP.md §A item 2.6, the filesystem cost model"


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({item})")
