"""Checkpoint / resume of the control state (port of `checkpoint.py`).

The reference's control-loop memory (initial_guess py:136, last_control
py:117, waiting_time py:361, old_goal py:146) is lost on restart. Here a
`ControlState`, one lane or a batch of lanes, round-trips in one of two
formats, chosen by the path:

- A path ending in `.npz` is one .npz file whose arrays are named by the
  state's fields, the layout the JAX package writes: a checkpoint saved by
  either package loads into the other.
- Any other path is a directory of `torch.distributed.checkpoint` (DCP),
  PyTorch's sharded checkpoint, in place of the JAX package's orbax
  directory: one tensor a field, keyed by its name. A fleet sharded over a
  world of ranks (`parallel.sharding`) saves collectively, each rank its own
  lanes, and loads into the shards of any world whose size divides the
  lanes, or whole into one process without a process group. Only this
  package reads it; an orbax directory written by the JAX package is
  refused (orbax needs JAX): the two packages cross through a .npz.

    >>> save_state("fleet", state)                  # one writer
    >>> load_state("fleet", device="cpu")           # whole, no group needed
    >>> save_state("fleet", shard, mesh=mesh)       # on every rank
    >>> load_state("fleet", mesh=mesh)              # this rank's shard
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import warnings

import numpy as np
import torch

from .engine import ControlState

__all__ = ["save_state", "load_state"]

# Derived, not hand-listed, so that a new ControlState field round-trips.
_FIELDS = [f.name for f in dataclasses.fields(ControlState)]


def save_state(path: str, state: ControlState, mesh=None) -> None:
    """Write `state` to `path`: an .npz file (one array a field) or a DCP
    directory (one tensor a field), which replaces what `path` held.

    mesh: None, and `state` is the whole state (one lane or a batch),
    written by this process alone even inside a process group. A DeviceMesh
    over the world (`parallel.sharding.make_mesh`), and `state` is this
    rank's contiguous shard of the lanes (`ShardedEngine.init_state` /
    `shard`): the save is collective, every rank calls it, each writes its
    own lanes and rank 0 the metadata. The save is synchronous."""
    path = str(path)
    if path.endswith(".npz"):
        if mesh is not None:
            raise ValueError("a sharded save needs a directory, not an .npz")
        np.savez(path, **{f: getattr(state, f).detach().cpu().numpy()
                          for f in _FIELDS})
        return
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    tensors = {f: getattr(state, f) for f in _FIELDS}
    writer = mesh is None or dist.get_rank() == 0
    if mesh is not None:
        from torch.distributed.tensor import DTensor, Shard

        # Shard(0) on every mesh dimension splits the lanes host-major,
        # then chip: rank r's slice is r of the world, as shard_batch's.
        tensors = {f: DTensor.from_local(t, mesh, [Shard(0)] * mesh.ndim)
                   for f, t in tensors.items()}
    # Written beside `path` and moved into place when complete, so that a
    # failed save leaves the earlier checkpoint, and a save from a smaller
    # world leaves no shard files of a larger one.
    partial = path + ".partial"
    if writer:
        shutil.rmtree(partial, ignore_errors=True)
    if mesh is not None:
        dist.barrier()
    with _single_process_quiet():
        dcp.save(tensors, storage_writer=dcp.FileSystemWriter(partial),
                 no_dist=mesh is None)
    if writer:
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(partial, path)
    if mesh is not None:
        dist.barrier()


def load_state(path: str, template=None, device="cuda",
               mesh=None) -> ControlState:
    """Inverse of save_state, on `device` (the card unless the caller asks
    for the CPU).

    An .npz: the whole state; template is accepted for the JAX package's
    signature and needs no match. A DCP directory: with mesh None, the
    whole state, its shapes and dtypes read from the checkpoint's metadata;
    with a mesh (every rank calls it), this rank's contiguous shard of the
    lanes on its own device, whatever world saved it, for any world whose
    size divides the lanes. A template given for a directory must match
    what is loaded (the whole state, or the shard), field for field in
    shape and dtype, or ValueError. A directory that is no DCP checkpoint
    (an orbax directory of the JAX package) raises ValueError."""
    path = str(path)
    if path.endswith(".npz"):
        del template
        with np.load(path) as z:
            return ControlState(**{f: torch.as_tensor(z[f], device=device)
                                   for f in _FIELDS})
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory {path!r}")
    if not os.path.isfile(os.path.join(path, ".metadata")):
        raise ValueError(
            f"{path!r} is not a torch.distributed.checkpoint directory (an "
            "orbax directory of the JAX package reads only there): cross "
            "between the packages through a .npz checkpoint")
    reader = dcp.FileSystemReader(path)
    meta = reader.read_metadata().state_dict_metadata
    missing = [f for f in _FIELDS if f not in meta]
    if missing:
        raise ValueError(f"checkpoint {path!r} lacks the fields {missing}")
    shapes = {f: (tuple(meta[f].size), meta[f].properties.dtype)
              for f in _FIELDS}
    if mesh is not None:
        from torch.distributed.tensor import DTensor, Shard

        from .parallel.sharding import _rank_device

        lanes, world = shapes[_FIELDS[0]][0][0], mesh.size()
        if lanes % world:
            raise ValueError(f"a checkpoint of {lanes} lanes does not "
                             f"divide over {world} ranks")
        shapes = {f: ((s[0] // world,) + s[1:], d)
                  for f, (s, d) in shapes.items()}
        device = _rank_device(mesh)
    if template is not None:
        for f, want in shapes.items():
            t = getattr(template, f)
            if (tuple(t.shape), t.dtype) != want:
                raise ValueError(
                    f"checkpoint field {f} is {want}, the template's "
                    f"{(tuple(t.shape), t.dtype)}")
    tensors = {f: torch.empty(s, dtype=d, device=device)
               for f, (s, d) in shapes.items()}
    if mesh is None:
        with _single_process_quiet():
            dcp.load(tensors, storage_reader=reader, no_dist=True)
        return ControlState(**tensors)
    tensors = {f: DTensor.from_local(t, mesh, [Shard(0)] * mesh.ndim)
               for f, t in tensors.items()}
    dcp.load(tensors, storage_reader=reader)
    return ControlState(**{f: t.to_local() for f, t in tensors.items()})


@contextlib.contextmanager
def _single_process_quiet():
    """DCP warns on every single-process save or load that it assumes one
    process; that is the intent here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message="torch.distributed is disabled")
        yield
