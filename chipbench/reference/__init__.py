"""Plain references of each architecture family (see harness.py)."""
