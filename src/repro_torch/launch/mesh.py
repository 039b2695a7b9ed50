"""The dry-run's production mesh and the H100's roofline constants (the
counterpart of the JAX package's launch/mesh.py).

A mesh of more than one device is a DeviceMesh over a fake world: a
process group of the `fake` backend (torch.testing's, over a FakeStore)
with 256 or 512 ranks, all of them this one process, as rank 0.  Its
collectives complete at once and, over fake tensors, move nothing: the
accounting reads them (launch/cost_analysis.py).  The fake world is the
default process group, so the dry-run is a process entry point, as the
JAX one is (its device count is fixed at the first backend init): a
process that already has a group (a test worker's, the serve CLI's) runs
it in a child.  A one-device mesh needs no group and no DTensor: its
cells trace on plain fake tensors, the program the card runs.

The constants are the NVIDIA H100 SXM5 80GB's, from NVIDIA's datasheet,
for the card this port is measured on (NVIDIA H100 80GB HBM3, power
limit 700.00 W): dense bf16 peak, HBM3 rate, NVLink rate a direction per
GPU inside an 8-GPU node, InfiniBand NDR rate per GPU across nodes.
HBM_BYTES is what torch.cuda.get_device_properties(0).total_memory
reports on that card.  A mesh dim whose groups each lie inside one node
(ranks 8n..8n+7) moves over NVLink, any other over InfiniBand: the
reference's "model" axis of 16 spans two nodes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

PEAK_FLOPS_BF16 = 989e12     # FLOP/s, dense (datasheet)
HBM_BW = 3.35e12             # B/s (datasheet)
HBM_BYTES = 85_017_493_504   # B, total_memory on the card (torch 2.11)
NVLINK_BW = 450e9            # B/s a direction per GPU in a node (datasheet)
IB_BW = 50e9                 # B/s per GPU across nodes, NDR (datasheet)
NODE_GPUS = 8
LINK_BW = {"nvlink": NVLINK_BW, "ib": IB_BW}


@dataclasses.dataclass
class Mesh:
    """Axis names and sizes, as the JAX Mesh's `shape` mapping gives
    them, and the DeviceMesh over the fake world (None on one device)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device_mesh: Optional[object] = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    def links(self) -> dict:
        """{process group name: "nvlink" | "ib"} of every mesh dim."""
        if self.device_mesh is None:
            return {}
        return {self.device_mesh.get_group(i).group_name: link_of(self, i)
                for i in range(len(self.sizes))}


def link_of(mesh: Mesh, dim: int) -> str:
    """The link a mesh dim's collectives take: NVLink if every group along
    it lies inside one node of NODE_GPUS ranks, else InfiniBand."""
    import numpy as np
    ranks = np.arange(mesh.size).reshape(mesh.sizes)
    groups = np.moveaxis(ranks, dim, -1).reshape(-1, mesh.sizes[dim])
    node = groups // NODE_GPUS
    return "nvlink" if bool((node == node[:, :1]).all()) else "ib"


def fake_world(world: int) -> None:
    """Make a fake process group of `world` ranks this process's default
    (rank 0), unless it already is one of that size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        raise RuntimeError(
            f"this process already has a {dist.get_backend()} process group "
            f"of {dist.get_world_size()} ranks; the dry-run's fake world of "
            f"{world} must be the default group (run it in a process of "
            f"its own)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
              device: str = "cuda", world: int = 0) -> Mesh:
    """A mesh over the first prod(shape) ranks of a fake world of `world`
    ranks (its own size by default; one world serves both production
    meshes at 512)."""
    n = 1
    for s in shape:
        n *= s
    if n == 1:
        return Mesh(tuple(names), tuple(shape))
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    fake_world(max(world, n))
    dm = DeviceMesh(device, torch.arange(n).reshape(shape),
                    mesh_dim_names=tuple(names))
    return Mesh(tuple(names), tuple(shape), dm)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda",
                         world: int = 0) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device, world)


def make_test_mesh() -> Mesh:
    """One device with the production axis names."""
    return make_mesh((1, 1), ("data", "model"))
