"""Production meshes and H100 constants (port of ``repro.launch.mesh``).

``make_production_mesh`` is a FUNCTION, so importing this module starts no
process group. It builds the reference's meshes, ``(16, 16)`` over
``("data", "model")`` and ``(2, 16, 16)`` over ``("pod", "data", "model")``,
over a fake process group of 256 or 512 ranks (``torch.distributed``'s
"fake" backend: every collective returns at once and moves nothing), which
it starts unless one of that size is already there. This process is rank
0, the device whose numbers the launch tools report. No card is needed: the
dry-run's tensors are meta tensors (``launch/dryrun.py``).

H100 SXM constants for the roofline model (per GPU; NVIDIA's data sheet,
dense rates at the 700 W limit). The collective term charges each
collective at the link of its group: NVLink inside a node of 8 GPUs, the
node's network (one 400 Gb/s NIC per GPU) across nodes. On both production
meshes every group crosses nodes: a ``model`` group is 16 consecutive ranks
(two nodes), a ``data`` group ranks 16 apart (16 nodes), a ``pod`` group
ranks 256 apart.
"""
from __future__ import annotations

import math

import torch.distributed as dist

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, bf16 tensor cores, dense
HBM_BW = 3.35e12  # bytes/s
HBM_BYTES = 85_017_493_504  # total_memory of an NVIDIA H100 80GB HBM3 (700.00 W limit), chip_smoke.py phase 27
NVLINK_BW = 450e9  # bytes/s per direction per GPU, to the other 7 GPUs of its node
NIC_BW = 50e9  # bytes/s per GPU across nodes (400 Gb/s)
GPUS_PER_NODE = 8


def mesh_shape(multi_pod: bool) -> tuple[tuple[int, ...], tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def start_fake_world(world_size: int) -> bool:
    """Start a fake process group of ``world_size`` ranks, this process
    rank 0. Returns False where one of that size is already the default
    group; raises where another group is."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers the "fake" backend

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world_size:
            return False
        raise RuntimeError(f"a {dist.get_backend()} process group of {dist.get_world_size()} ranks is "
                           f"already started; the production mesh needs a fake one of {world_size}")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    return True


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) or (2, 16, 16) DeviceMesh on a fake process group."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = mesh_shape(multi_pod)
    start_fake_world(math.prod(shape))
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def link_of(ranks: list[int]) -> str:
    """The link a collective over ``ranks`` crosses: 'local' for one rank
    (it moves nothing), 'nvlink' inside one node, 'nic' across nodes."""
    if len(ranks) == 1:
        return "local"
    return "nvlink" if len({r // GPUS_PER_NODE for r in ranks}) == 1 else "nic"


LINK_BW = {"nvlink": NVLINK_BW, "nic": NIC_BW}
