"""
The device mesh of the PyTorch port on `torch.distributed` (mirrors
`brutus_tpu/parallel/mesh.py`).

The JAX package lays its devices out as a 2-D mesh `("data", "model")`:
the star batch is split over `data` and the grid of models over
`model`.  Here one process (a rank) runs per device, and a `Mesh`
holds this rank's place in that layout, its device, and the process
groups of its row and column (`init_device_mesh`'s layout: rank
`d * n_model + m` sits at `(d, m)`).  Where the JAX package lets GSPMD
turn reductions over a sharded axis into collectives, the port's
sharded paths call the collectives below explicitly (`BruteForce.fit`
with `mesh=`; the model-sharded merges live in `ops/funnel.py`,
`ops/screen_xla.py`, `ops/optimize.py` and `ops/posterior.py`).

Transport: NCCL between CUDA devices, gloo for the CPU.  A gloo group
carries CUDA tensors through host copies (`all_reduce`), which is how
several ranks share one card.  An all-gather is written as an
all-reduce SUM into per-rank slots of a zero tensor: exact (each slot
has one non-zero contribution), and the same call on every backend and
version of torch.  A failed collective raises; every world is made with
a timeout, so a hung rank fails instead of stalling.
"""

import datetime
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

# Timeout of a world this module creates (a collective waits this long).
TIMEOUT = datetime.timedelta(seconds=600)


def _default_device(world):
    """A rank's device when `make_mesh` is not given `devices`: its
    current CUDA device.  Without a card this raises, as
    `utils.resolve_device(None)` does: a CPU mesh is asked for by
    naming its devices."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: brutus_tpu_torch runs on CUDA devices by default "
            "and none is available; pass devices=['cpu'] * "
            f"{world} for a mesh on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_ids=None):
    """Join this process to a `torch.distributed` world (mirrors
    `brutus_tpu.parallel.initialize`, which wraps
    `jax.distributed.initialize`).  Idempotent: a default process group
    that already exists counts as joined.

    `coordinator_address` is a rendezvous URL (`tcp://host:port`,
    `file:///path`) or `host:port`, with `num_processes` ranks of which
    this is `process_id`.  Without it, torchrun's `env://` variables
    are read when set; a single process with neither warns and carries
    on, as the JAX package does (its mesh then spans this process's
    device).  The backend is NCCL for CUDA devices (the device is
    `local_device_ids[0]`, else `LOCAL_RANK`, else the rank modulo the
    device count) and gloo for the CPU.  A world of several processes
    that cannot be joined raises.
    """
    if dist.is_initialized():
        return
    env = all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                        "WORLD_SIZE", "RANK"))
    if coordinator_address is None and not env:
        if num_processes not in (None, 1):
            raise ValueError(f"initialize: {num_processes} processes need "
                             "a coordinator_address (or torchrun's env:// "
                             "variables)")
        warnings.warn("initialize: no coordinator and no env:// variables; "
                      "continuing single-process")
        return
    if coordinator_address is None:
        init, kw = "env://", {}
        rank = int(os.environ["RANK"])
    else:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
        kw = dict(world_size=int(num_processes or 1),
                  rank=int(process_id or 0))
        rank = kw["rank"]
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        if local_device_ids is not None:
            local = int(np.atleast_1d(local_device_ids)[0])
        else:
            local = int(os.environ.get("LOCAL_RANK",
                                       rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    try:
        dist.init_process_group(backend, init_method=init, timeout=TIMEOUT,
                                **kw)
    except (ValueError, RuntimeError) as err:
        if num_processes not in (None, 1) or env:
            raise
        warnings.warn(f"initialize: torch.distributed unavailable ({err}); "
                      "continuing single-process")


def _mesh_shape(n, n_data=None, n_model=None):
    """`(n_data, n_model)` of a mesh over `n` devices, with
    `brutus_tpu.parallel.make_mesh`'s defaults (all on `model`) and its
    `ValueError`."""
    if n_data is None and n_model is None:
        n_data, n_model = 1, n
    elif n_data is None:
        n_data = n // n_model
    elif n_model is None:
        n_model = n // n_data
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} devices")
    return n_data, n_model


class Mesh:
    """This rank's place in a `("data", "model")` mesh (see the module
    docstring).  `shape` maps the axis names to their sizes, as the JAX
    mesh's does; `coords` is `(data index, model index)`; `device` this
    rank's device; `get_group(axis)` the process group of the ranks that
    share this rank's other coordinate (None in a world of one, where
    every collective is the identity); `first` whether this is the
    mesh's first rank."""

    axis_names = ("data", "model")

    def __init__(self, n_data, n_model, device, devices):
        self.shape = {"data": n_data, "model": n_model}
        self.size = n_data * n_model
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.coords = divmod(self.rank, n_model)
        self.device = torch.device(device)
        self.devices = np.empty((n_data, n_model), dtype=object)
        for i, d in enumerate(devices):
            self.devices[divmod(i, n_model)] = d
        self.device_mesh = None
        self.backend = None
        if dist.is_initialized():
            from torch.distributed.device_mesh import init_device_mesh
            self.backend = dist.get_backend()
            kind = "cuda" if self.backend == "nccl" else "cpu"
            self.device_mesh = init_device_mesh(
                kind, (n_data, n_model), mesh_dim_names=self.axis_names)

    @property
    def first(self):
        return self.rank == 0

    def get_group(self, axis):
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    @property
    def world(self):
        """The group of every rank of the mesh (None in a world of one)."""
        return dist.group.WORLD if self.device_mesh is not None else None

    def transport(self):
        """How this mesh's collectives travel, for logs."""
        if self.backend is None:
            return "none (a world of one)"
        if self.backend == "gloo" and self.device.type == "cuda":
            return "gloo, CUDA tensors staged through host memory"
        return self.backend

    def __repr__(self):
        return (f"Mesh(data={self.shape['data']}, model="
                f"{self.shape['model']}, rank={self.rank}, coords="
                f"{self.coords}, device={self.device})")


def make_mesh(n_data=None, n_model=None, devices=None):
    """A `("data", "model")` mesh over the ranks of this world (mirrors
    `brutus_tpu.parallel.make_mesh`: by default every rank on the model
    axis; `ValueError` when the sizes do not multiply to the device
    count).  One rank runs per device: `devices` lists each rank's
    device (default: each rank's current CUDA device; without a card
    that raises, and a CPU mesh is `devices=["cpu"] * world_size`), and
    its length must equal the world size.  Every rank of the world
    calls this together."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if devices is None:
        devices = [None] * world
    devices = list(devices)
    n_data, n_model = _mesh_shape(len(devices), n_data, n_model)
    if len(devices) != world:
        raise ValueError(f"mesh over {len(devices)} devices needs one rank "
                         f"per device; this world has {world}")
    mine = (torch.device(devices[rank]) if devices[rank] is not None
            else _default_device(world))
    devices = [mine if i == rank else d for i, d in enumerate(devices)]
    return Mesh(n_data, n_model, mine, devices)


def _placements(*shards):
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if s else Replicate() for s in shards)


def model_sharding(mesh):
    """DTensor placements of grid-axis-leading arrays `(M, ...)` split
    over `model` (JAX: `NamedSharding(mesh, P("model"))`)."""
    return _placements(False, True)


def data_sharding(mesh):
    """DTensor placements of star-batch-leading arrays `(B, ...)` split
    over `data` (JAX: `P("data")`)."""
    return _placements(True, False)


def replicated(mesh):
    return _placements(False, False)


def pad_to_multiple(x, multiple, axis=0, fill=None):
    """Pad `x` along `axis` to a multiple of `multiple` (the port's copy
    of `brutus_tpu.parallel.pad_to_multiple`): repeat the edge, or
    `fill`.  Returns `(padded, original length)`."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, rem)
    if fill is None:
        out = np.pad(x, pad_width, mode="edge")
    else:
        out = np.pad(x, pad_width, mode="constant", constant_values=fill)
    return out, n


def pad_grid(mag_coeffs, multiple):
    """`(M, F, 3)` coefficients padded to a multiple of `multiple` models
    with copies of the last model 60 mag fainter (`shard_grid`'s and
    `prepare_screen_xla`'s padding)."""
    mc = np.asarray(mag_coeffs)
    rem = (-mc.shape[0]) % multiple
    if rem:
        pad = np.repeat(mc[-1:], rem, axis=0).copy()
        pad[..., 0] += 60.0   # unreachably faint
        mc = np.concatenate([mc, pad], axis=0)
    return mc


def shard_grid(mesh, mag_coeffs, *label_arrays):
    """This rank's contiguous slice of the model grid over the mesh's
    `model` axis, padded as `brutus_tpu.parallel.shard_grid` pads it:
    the grid to the shard count with copies of the last model 60 mag
    fainter, each label array by repeating its last row.  Returns
    `(mag_coeffs_local, labels_local_tuple, n_real_models)`, as tensors
    on the mesh's device (None stays None)."""
    n_shards = mesh.shape["model"]
    shard = mesh.coords[1]
    mc = np.asarray(mag_coeffs)
    n = mc.shape[0]
    mc = pad_grid(mc, n_shards)
    m = mc.shape[0] // n_shards
    part = slice(shard * m, (shard + 1) * m)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a[part])).to(
        mesh.device)
    labels = []
    for arr in label_arrays:
        if arr is None:
            labels.append(None)
            continue
        labels.append(put(pad_to_multiple(np.asarray(arr), n_shards)[0]))
    return put(mc), tuple(labels), n


# ---------------------------------------------------------------------------
# Collectives of the sharded paths
# ---------------------------------------------------------------------------

def group_size(group):
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group):
    return 0 if group is None else dist.get_rank(group)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x, op, group):
    """`x` reduced (`op` "sum" or "max") over `group`, as a new tensor;
    `x` itself when the group is one rank."""
    if group_size(group) == 1:
        return x
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    y = x.detach().to("cpu", copy=True) if staged else x.clone()
    dist.all_reduce(y, op=_OPS[op], group=group)
    return y.to(x.device) if staged else y


def all_gather(x, group, dim=0):
    """The group's `x`s concatenated along `dim` in rank order (an
    all-reduce SUM into per-rank slots of a zero tensor: exact)."""
    n = group_size(group)
    if n == 1:
        return x
    k = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * k
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(dim, group_rank(group) * k, k).copy_(x)
    return all_reduce(out, "sum", group)


__all__ = ["initialize", "make_mesh", "model_sharding", "data_sharding",
           "replicated", "shard_grid", "pad_to_multiple", "Mesh",
           "all_reduce", "all_gather", "group_size", "group_rank"]
