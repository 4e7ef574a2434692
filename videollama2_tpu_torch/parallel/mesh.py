"""Device mesh construction (port of videollama2_tpu/parallel/mesh.py).

The JAX package names a `jax.sharding.Mesh`; here the same five axes name
the dimensions of a `torch.distributed` DeviceMesh over the ranks of a
process group (one rank a card, as `torchrun` launches them):

  data   - pure data parallelism (batch sharding)
  fsdp   - ZeRO-3 parameter / optimizer sharding (+ batch sharding)
  tensor - Megatron tensor parallelism (heads / FFN channels)
  expert - Mixtral expert parallelism (the E dimension)
  seq    - Ulysses sequence parallelism (training: tokens shard over
           `seq` everywhere except attention, which all-to-alls to head
           sharding; parallel/sharding.sequence_parallel)

The axes keep JAX's order, `tensor` inside `fsdp` and `data`, so the
tensor-parallel collectives of every layer run between neighbouring ranks
(one node's NVLink) and only the gradient reductions cross `data`.

A mesh of one rank needs no process group: `single_device_mesh()` and
`make_mesh()` at world size one without one run every collective as the
identity, so a plain `python -m ...` stays a one-rank run.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

AXIS_NAMES = ("data", "fsdp", "tensor", "expert", "seq")
# every collective of a process group made here fails after this long
# rather than waiting on a rank that hung or died
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


class Mesh:
    """The five named axes over a set of ranks.

    shape: {axis: size}; coord: {axis: this rank's index}, None when this
    rank is not in the mesh (a mesh over a subset of the world). `group(a)`
    is the process group of this rank's line along axis a, None when the
    axis has size one (its collectives are the identity). Entering the mesh
    (`with mesh:`) makes it the current one for the model's entry points,
    as JAX's `with mesh:` does (parallel/sharding.current_mesh)."""

    def __init__(self, shape: Dict[str, int], device_mesh=None,
                 device: Optional[torch.device] = None):
        self.shape = dict(shape)
        self.device_mesh = device_mesh
        self.device = device
        if device_mesh is None:
            self.coord = dict.fromkeys(AXIS_NAMES, 0)
        else:
            c = device_mesh.get_coordinate()
            self.coord = None if c is None else dict(zip(AXIS_NAMES, c))
        self._groups = {}
        self._tokens = []

    @property
    def member(self) -> bool:
        return self.coord is not None

    @property
    def size(self) -> int:
        n = 1
        for a in AXIS_NAMES:
            n *= self.shape[a]
        return n

    @property
    def is_main(self) -> bool:
        """The mesh's first rank (every coordinate 0): the one that logs
        and writes."""
        return self.member and not any(self.coord.values())

    def index(self, axis: str) -> int:
        return self.coord[axis]

    def group(self, axis: str):
        if self.shape[axis] == 1:
            return None
        if axis not in self._groups:
            self._groups[axis] = self.device_mesh.get_group(axis)
        return self._groups[axis]

    def __enter__(self):
        from . import sharding
        self._tokens.append(sharding._push_mesh(self))
        return self

    def __exit__(self, *exc):
        from . import sharding
        sharding._pop_mesh(self._tokens.pop())
        return False

    def __repr__(self):
        dims = "x".join(f"{a}{self.shape[a]}" for a in AXIS_NAMES)
        return f"Mesh({dims}, coord={self.coord})"


def init_distributed(device: str = "cuda", store=None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout: datetime.timedelta = COLLECTIVE_TIMEOUT
                     ) -> torch.device:
    """Join (or start) the default process group from torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT)
    or the arguments, and return this rank's device. On "cuda" the rank
    takes card LOCAL_RANK and the group is NCCL; "cpu" (the tests) takes
    gloo. `store` (a torch.distributed Store, e.g. a FileStore) replaces
    the env:// rendezvous. Every collective times out after `timeout`."""
    device = torch.device(device)
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device is "
                               "available; pass device='cpu' for gloo")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: unsupported device {device}")
    if dist.is_initialized():
        return device
    kwargs = dict(backend=backend, rank=rank, world_size=world_size,
                  timeout=timeout)
    if store is not None:
        kwargs["store"] = store
    elif "MASTER_ADDR" not in os.environ:
        if world_size != 1:
            raise RuntimeError("init_distributed: no MASTER_ADDR / store "
                               "for a group of more than one rank")
        kwargs["store"] = dist.HashStore()
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(**kwargs)
    return device


def make_mesh(data: int = 1, fsdp: int = -1, tensor: int = 1,
              expert: int = 1, seq: int = 1,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """Build a mesh over the ranks `devices` (default: every rank of the
    default group; one rank when there is none). fsdp=-1 absorbs the
    remainder. Every rank of the default group must call it alike (the
    axis groups are made collectively); a rank outside `devices` gets a
    mesh with coord None."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if devices is None else list(devices)
    n = len(ranks)
    fixed = data * tensor * expert * seq
    if fsdp == -1:
        assert n % fixed == 0, (n, fixed)
        fsdp = n // fixed
    assert data * fsdp * tensor * expert * seq == n, \
        f"mesh {data}x{fsdp}x{tensor}x{expert}x{seq} != {n} devices"
    shape = dict(zip(AXIS_NAMES, (data, fsdp, tensor, expert, seq)))
    if not dist.is_initialized():
        return Mesh(shape)
    backend = dist.get_backend()
    device_type = "cuda" if backend == "nccl" else "cpu"
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    dims = (data, fsdp, tensor, expert, seq)
    if devices is None:
        from torch.distributed.device_mesh import init_device_mesh
        dm = init_device_mesh(device_type, dims, mesh_dim_names=AXIS_NAMES)
    else:
        from torch.distributed.device_mesh import DeviceMesh
        dm = DeviceMesh(device_type, torch.tensor(ranks).reshape(dims),
                        mesh_dim_names=AXIS_NAMES)
    return Mesh(shape, dm, device)


def single_device_mesh() -> Mesh:
    """A one-rank mesh with no process group: every collective is the
    identity."""
    return Mesh(dict.fromkeys(AXIS_NAMES, 1))
