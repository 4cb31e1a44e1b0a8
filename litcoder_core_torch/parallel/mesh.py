"""Device meshes and voxel-axis sharding (twin of
litcoder_core_tpu/parallel/mesh.py).

A mesh is a grid of `torch.device`s that one Python process drives, as
JAX's single-controller `Mesh` is: no process group and no launcher. Per-
voxel ridge problems are independent, so the responses, alphas, weights
and metrics split on the voxel axis (`VoxelShards`, one column block per
mesh entry) while the stimuli replicate, one copy per distinct device. A
mesh may repeat a device (`["cuda:0"] * 4`, `["cpu"] * 8`): its shards
then share that device, which is how one card or the CPU runs the shard,
replicate and gather logic of a many-card mesh.

Every placement the helpers make is appended to the mesh's `transfers`
list as (kind, shape): 'shard' per column block placed, 'replicate' per
distinct-device copy, 'gather' per shard collected.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

VOX_AXIS = "vox"


def _as_device(d) -> torch.device:
    dev = torch.device(d)
    if (dev.type == "cuda" and dev.index is None
            and torch.cuda.is_available()):
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An n-D grid of torch devices with named axes.

    devices: numpy object array of `torch.device`; axis_names: one name per
    grid axis; shape: {axis name: extent}; size: number of entries."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        self.devices = np.empty(grid.shape, dtype=object)
        for pos in np.ndindex(grid.shape):
            self.devices[pos] = _as_device(grid[pos])
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"{self.devices.ndim}-D device grid for axes "
                f"{self.axis_names}")
        if self.devices.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.transfers: List = []

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> List[torch.device]:
        """The mesh's devices without repeats, in grid order."""
        out: List[torch.device] = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out


def make_mesh(n_devices: Optional[int] = None, devices=None,
              axis: str = VOX_AXIS) -> Mesh:
    """1-D mesh over `axis`: the given `devices` (which may repeat one), or
    the first n_devices CUDA cards.

    Raises RuntimeError when fewer than n_devices cards exist: truncating
    would build a mis-sized mesh that fails later far from its cause."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        cards = [torch.device("cuda", i) for i in range(count)]
        if n_devices is not None:
            if count < n_devices:
                raise RuntimeError(
                    f"make_mesh({n_devices}) needs {n_devices} devices but "
                    f"only {count} exist (platform=cuda); provision more "
                    f"cards, or pass devices= (a list may repeat a device, "
                    f"e.g. ['cpu'] * {n_devices})"
                )
            cards = cards[:n_devices]
        if not cards:
            raise RuntimeError(
                "make_mesh() found no CUDA device (platform=cuda); pass "
                "devices= to build a mesh on the CPU")
        devices = cards
    return Mesh(np.asarray(list(devices), dtype=object), (axis,))


def resolve_voxel_mesh(mesh, n_devices: Optional[int], who: str = "fit",
                       device="cuda") -> Optional[Mesh]:
    """Resolve a fit's `mesh`/`n_devices` into a 1-D voxel mesh (or None).

    With `n_devices` alone the mesh takes the first n cards, or n entries
    of the CPU when the fit's `device` is the CPU. The mesh's devices must
    be of the fit's device type: a CUDA fit never runs on a CPU mesh."""
    if mesh is None and n_devices is None:
        return None
    dev = torch.device(device)
    if mesh is None:
        mesh = (make_mesh(devices=[dev] * n_devices) if dev.type == "cpu"
                else make_mesh(n_devices))
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"{who} expects a litcoder_core_torch.parallel.mesh.Mesh; got "
            f"{type(mesh).__name__}")
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"{who} expects a 1-D (voxel) mesh; got axes {mesh.axis_names}"
        )
    if n_devices is not None and mesh.size != n_devices:
        raise ValueError(
            f"mesh has {mesh.size} devices but n_devices="
            f"{n_devices} was requested; pass one or the other"
        )
    kinds = {d.type for d in mesh.devices.flat}
    if kinds != {dev.type}:
        raise ValueError(
            f"{who} runs on {str(device)!r} but the mesh's devices are "
            f"{sorted(kinds)}")
    return mesh


class VoxelShards:
    """An array of shape (..., V) split on its last axis into equal column
    blocks, block i on mesh entry i (the port's counterpart of a jax.Array
    sharded over 'vox')."""

    def __init__(self, shards: Sequence[torch.Tensor], mesh: Mesh):
        self.shards = list(shards)
        self.mesh = mesh

    @property
    def shape(self):
        lead = tuple(self.shards[0].shape[:-1])
        return lead + (sum(int(s.shape[-1]) for s in self.shards),)

    def gather(self, device) -> torch.Tensor:
        """The whole array on `device` (shards concatenated in order)."""
        dev = torch.device(device)
        parts = []
        for s in self.shards:
            self.mesh.transfers.append(("gather", tuple(s.shape)))
            parts.append(s.to(dev))
        return torch.cat(parts, dim=-1)


def pad_voxels(Y, n_devices: int):
    """Pad the last (voxel) axis with zeros to a multiple of n_devices.
    Returns (padded tensor, original count)."""
    Y = torch.as_tensor(Y)
    v = Y.shape[-1]
    pad = (-v) % n_devices
    if pad:
        Y = torch.nn.functional.pad(Y, (0, pad))
    return Y, v


def shard_voxels(array, mesh: Mesh, axis: str = VOX_AXIS) -> VoxelShards:
    """Split an array's LAST axis over the mesh: block i, a copy of its
    columns, goes to mesh entry i. Works for (T, V) responses, (V,) alphas
    and (D, V) weights; a numpy array goes to each device block by block,
    never whole. The voxel count must be a multiple of the mesh size (pad
    with `pad_voxels` first)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    n = mesh.size
    v = int(array.shape[-1])
    if v % n:
        raise ValueError(
            f"voxel axis ({v}) not divisible by mesh size ({n}); pad it "
            "with pad_voxels first")
    w = v // n
    shards = []
    for i, dev in enumerate(mesh.devices.flat):
        block = array[..., i * w:(i + 1) * w]
        if isinstance(block, torch.Tensor):
            block = block.to(dev).contiguous()
        else:
            block = torch.as_tensor(np.ascontiguousarray(block), device=dev)
        mesh.transfers.append(("shard", tuple(block.shape)))
        shards.append(block)
    return VoxelShards(shards, mesh)


def shard_padded(array, mesh: Mesh) -> VoxelShards:
    """`array` as float32 (a tensor stays where it is), its last axis
    zero-padded to a multiple of the mesh size, sharded: how a fit places
    its responses."""
    array = (array.to(torch.float32) if isinstance(array, torch.Tensor)
             else np.asarray(array, np.float32))
    return shard_voxels(pad_voxels(array, mesh.size)[0], mesh)


def replicate(array, mesh: Mesh) -> Dict[torch.device, torch.Tensor]:
    """One copy of `array` per distinct mesh device, keyed by device (the
    array itself where it already lives there)."""
    out = {}
    for dev in mesh.distinct_devices():
        t = (array.to(dev) if isinstance(array, torch.Tensor)
             else torch.as_tensor(np.asarray(array), device=dev))
        mesh.transfers.append(("replicate", tuple(t.shape)))
        out[dev] = t
    return out
