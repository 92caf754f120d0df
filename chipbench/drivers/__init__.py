"""One driver a traffic kind (see harness.py)."""
