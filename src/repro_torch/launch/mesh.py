"""Device meshes on ``torch.distributed``.

The counterpart of ``repro.launch.mesh``. A mesh is a ``DeviceMesh`` whose
``mesh_dim_names`` are the JAX package's axis names, over the ranks of the
default process group, one rank per device:

  * single pod: (data=16, model=16), 256 ranks;
  * multi-pod: (pod=2, data=16, model=16), 512 ranks; "pod" is a pure-DP
    axis (the cross-pod gradient reduction is its only collective), or the
    pipeline axis of ``distributed.pipeline``.

Every mesh is built by a function, never at import. Outside a process group
a mesh first starts one of a single rank (NCCL on ``cuda``, gloo on
``cpu``) whose store is a file in a fresh temporary directory, so no port
is fixed; under ``python -m torch.distributed.run`` the group comes from its
environment (``env://``). A mesh on ``cuda`` with no card raises, and a
failed NCCL start raises: nothing falls back to gloo or the host.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Sequence

import torch
import torch.distributed as dist

#: How long a collective may wait for its peers before the group fails.
TIMEOUT = datetime.timedelta(seconds=120)

PRODUCTION_SHAPE = {False: ((16, 16), ("data", "model")),
                    True: ((2, 16, 16), ("pod", "data", "model"))}


def _device_type(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a mesh on %r needs a CUDA device; pass device='cpu' for gloo ranks "
                           "on the host" % str(device))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("device must be 'cuda' or 'cpu', got %r" % str(device))
    return dev.type


def ensure_process_group(device="cuda") -> None:
    """Start the default process group if there is none: from the
    environment under ``torch.distributed.run``, else a single rank with a
    file store. NCCL on ``cuda`` (each rank on card ``LOCAL_RANK``), gloo
    on ``cpu``. Raises if the backend cannot start."""
    kind = _device_type(device)
    if kind == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if dist.is_initialized():
        return
    backend = "nccl" if kind == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, timeout=TIMEOUT)
        return
    store = os.path.join(tempfile.mkdtemp(prefix="repro-torch-pg-"), "store")
    dist.init_process_group(backend, init_method="file://" + store, rank=0, world_size=1,
                            timeout=TIMEOUT)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    process group (started here if there is none)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    ensure_process_group(device)
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError("a mesh of shape %s needs %d ranks; the process group has %d"
                         % (shape, n, world))
    return init_device_mesh(_device_type(device), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``: 256 or 512 ranks; raises on a smaller group."""
    shape, axes = PRODUCTION_SHAPE[bool(multi_pod)]
    return make_mesh(shape, axes, device=device)


def make_host_mesh(*, device="cuda"):
    """Every rank of the process group as a (data, model) = (world, 1)
    mesh."""
    ensure_process_group(device)
    return make_mesh((dist.get_world_size(), 1), ("data", "model"), device=device)
