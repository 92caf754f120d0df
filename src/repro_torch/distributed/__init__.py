"""Sharded runs on a ``DeviceMesh``: the logical sharding rules
(``sharding.py``), port of ``repro.distributed``."""
