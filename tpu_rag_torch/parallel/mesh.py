"""Device mesh construction (port of tpu_rag/parallel/mesh.py).

A `Mesh` is an ndarray of torch.device with named axes, the counterpart of
jax.sharding.Mesh: `mesh.shape` maps axis names to sizes in axis order.
The default device list is every CUDA device, cuda:0..n-1.  A caller may
pass a list that names one device several times: each entry is a shard of
its own, and the shards of one device run one after another.  That is the
port's counterpart of XLA's virtual host devices, and how a mesh is
rehearsed on one card (or on the CPU: ["cpu"] * 8).

`axis_devices("data")` places row shards (parallel/sharded.py) and
`model_groups()` the tensor-parallel groups of the encoder and its trainer
(parallel/tensor.py): one group a data position, one device a model rank.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_rag_torch.device import resolve


class Mesh:
    """Devices laid out on named axes."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]) -> None:
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str = "data") -> list[torch.device]:
        """One device per position along `axis`: the first of that
        position's devices over every other axis.  A shard over `axis` is
        held once, on this device (tpu_rag replicates it over the other
        axes; the results are the same)."""
        pos = self.axis_names.index(axis)
        grid = np.moveaxis(self.devices, pos, 0).reshape(self.devices.shape[pos], -1)
        return [grid[i, 0] for i in range(grid.shape[0])]

    def model_groups(self) -> list[list[torch.device]]:
        """For each position on "data" (one position where the mesh has no
        "data" axis), the devices along "model" in rank order (one device
        where it has no "model" axis): the port's counterpart of a
        NamedSharding over ("data", "model").  Over any other axis, the
        first position's devices, as in axis_devices.  A device named more
        than once stays one device: the ranks on it run one after another."""
        names = list(self.axis_names)
        lead = [names.index(a) for a in ("data", "model") if a in names]
        grid = np.transpose(self.devices, lead + [i for i in range(len(names)) if i not in lead])
        grid = grid.reshape(self.shape.get("data", 1), self.shape.get("model", 1), -1)
        return [list(grid[i, :, 0]) for i in range(grid.shape[0])]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


def default_devices() -> list[torch.device]:
    """Every CUDA device; raises (device.resolve) without a card."""
    resolve("cuda")
    return [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]


def mesh_from_spec(spec: str = "", devices=None) -> Mesh:
    """Build a mesh from "axis:size,axis:size" (e.g. "data:4,model:2").

    Empty spec -> 1-D mesh over all devices on axis "data".
    A trailing size of -1 (or a missing size) absorbs remaining devices.
    """
    devices = [resolve(d) for d in devices] if devices is not None else default_devices()
    n = len(devices)
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    if not spec:
        return Mesh(grid, axis_names=("data",))
    names: list[str] = []
    sizes: list[int] = []
    for part in spec.split(","):
        name, _, size = part.strip().partition(":")
        names.append(name.strip())
        sizes.append(int(size) if size.strip() else -1)
    known = int(np.prod([s for s in sizes if s > 0])) if any(s > 0 for s in sizes) else 1
    sizes = [n // known if s == -1 else s for s in sizes]
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(f"mesh spec {spec!r} needs {total} devices, have {n}")
    return Mesh(grid.reshape(sizes), axis_names=tuple(names))
