"""Production and host meshes, and the card's constants for the roofline.

Functions, not module-level meshes: importing this module touches no
process group and no device.  Each builds a ``DeviceMesh`` with
``init_device_mesh`` over the process group that the caller set up
(``torch.distributed.init_process_group``): NCCL on cards, gloo on CPUs,
or the ``"fake"`` backend of the dry-run, whose ranks exist only as a
count.
"""
from __future__ import annotations

from typing import Optional

import torch

# The meshes of the reference: one pod of 16 x 16 = 256 ranks, two pods of
# them with a leading "pod" axis.
SINGLE = ((16, 16), ("data", "model"))
MULTI = ((2, 16, 16), ("pod", "data", "model"))

# NVIDIA H100 80GB HBM3 (SXM5) at its 700 W limit, dense, from the card's
# data sheet (the figures chip_smoke.py's bounds use).
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS_BF16 = 989e12  # per card, dense bf16 tensor cores
HBM_BW = 3.35e12  # bytes/s per card
# Link bandwidth per mesh axis, bytes/s each way per card: NVLink 4 (18
# links x 25 GB/s) inside an 8-card node; across nodes one 400 Gb/s
# InfiniBand NDR port per card.  On the 16 x 16 and 2 x 16 x 16 meshes
# with 8 cards a node, ranks are numbered model-fastest, so a 16-rank
# "model" group spans two nodes: every axis crosses nodes, and the
# network carries each of them.
NVLINK_BW = 450e9
NETWORK_BW = 50e9
CARDS_PER_NODE = 8
# torch.cuda.get_device_properties(0).total_memory on that card, for a
# dry-run on a machine without one.
H100_TOTAL_MEMORY = 85_017_493_504


def hbm_per_card(device: Optional[torch.device] = None) -> int:
    """The ``total_memory`` that the card reports; the H100 80GB HBM3's
    where no card is present (a dry-run on the CPU)."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(device or 0).total_memory)
    return H100_TOTAL_MEMORY


def axis_bandwidth(mesh_shape, axis: str) -> float:
    """The link bandwidth that carries ``axis`` of a mesh of ``mesh_shape``
    ({name: size}, model-fastest rank order): NVLink when the axis' group
    of ranks stays inside one node, the network otherwise."""
    names = list(mesh_shape)
    stride = 1
    for name in reversed(names):
        if name == axis:
            break
        stride *= mesh_shape[name]
    span = stride * mesh_shape[axis]
    return NVLINK_BW if span <= CARDS_PER_NODE else NETWORK_BW


def _mesh(shape, names, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16 x 16 = 256 ranks a pod; 2 pods = 512 ranks with a leading 'pod'
    axis.  The process group must hold that many ranks."""
    shape, names = MULTI if multi_pod else SINGLE
    return _mesh(shape, names, device_type)


def make_host_mesh(device_type: str = "cuda"):
    """``(world_size, 1)`` ``("data", "model")``: every rank of the process
    group on the data axis (the launcher under ``torchrun``)."""
    import torch.distributed as dist

    return _mesh((dist.get_world_size(), 1), ("data", "model"), device_type)
