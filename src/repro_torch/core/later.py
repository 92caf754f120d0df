"""The parts of ``repro.core`` that later slices of the port add, by the
ROADMAP.md item that queues each, and the error their entry points raise
until then."""
from __future__ import annotations

PACKS = "ROADMAP.md §A item 2.4, pack writing and gc"


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({item})")
