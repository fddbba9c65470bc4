"""Checkpoint: morphable dict/directory checkpoint container, port of
`ray_tpu/air/checkpoint.py:21-239`.

ray: python/ray/air/checkpoint.py:63 — a Checkpoint interconverts dict and
directory forms. Torch states (nested dicts and lists whose leaves are
tensors or other picklable values, such as a step count or a
`torch.Generator`) are first-class: a directory holds their tensors in
`torch.distributed.checkpoint` (DCP) form, where the JAX package uses
orbax. A sharded state is written rank by rank, each rank its own shards,
and restored onto any layout of any mesh, so that a checkpoint written
under one parallelism strategy restores under another.

The JAX package falls back to a pickle when orbax is missing; the port has
no fallback: DCP is always there, and a failure raises.
"""

from __future__ import annotations

import copy
import os
import pickle
import shutil
import tempfile
import uuid
import warnings
from contextlib import contextmanager
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch.parallel.mesh import mesh_axis_sizes
from ray_tpu_torch.parallel.sharding import shard_tensor

_STATE_KEY = "torch_state"
_STATE_DIR = "state"
# The state's tree, its tensors replaced by `_Tensor` markers (inside the
# state's directory, beside DCP's files).
_TREE_FILE = "tree.pkl"


class Checkpoint:
    """A checkpoint is either an in-memory dict or an on-disk directory."""

    _DICT_FILE = "checkpoint.pkl"

    def __init__(
        self,
        data: Optional[Dict[str, Any]] = None,
        directory: Optional[str] = None,
    ):
        if (data is None) == (directory is None):
            raise ValueError("provide exactly one of data= or directory=")
        self._data = data
        self._dir = directory
        self.id = uuid.uuid4().hex[:8]

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(directory=str(path))

    @classmethod
    def from_torch_state(cls, state, **extra) -> "Checkpoint":
        """Checkpoint a torch state: a host copy of every tensor (the
        rank's own; gather a sharded state first, or save it with
        from_torch_state_sharded), and a deep copy of every other leaf."""
        return cls.from_dict({_STATE_KEY: _to_host(state), **extra})

    @classmethod
    def from_torch_state_sharded(cls, state, directory: str, mesh, placements,
                                 **extra) -> "Checkpoint":
        """Scalable save: every rank of `mesh` calls this with its shards of
        `state`, and DCP writes each rank's own shards straight to
        `directory` (no gather, no full copy anywhere); a tensor every rank
        holds whole is written once. `placements` is a tree congruent with
        the state's tensors (`sharding.local_placements`, or
        `LMTrainContext.state_placements()`): per dim, the mesh axes that
        split it, the major first; a tensor it leaves out is whole on every
        rank. The directory must be storage every rank sees; the returned
        checkpoint is a lightweight directory reference."""
        path = os.path.abspath(directory)
        os.makedirs(path, exist_ok=True)
        _save_state(os.path.join(path, _STATE_DIR), state, mesh, placements)
        # One writer of the metadata pickle (ranks would otherwise truncate
        # each other's file), then a barrier: every rank must see the
        # complete directory before anyone reads the checkpoint back.
        if dist.get_rank() == 0:
            _write_pickle(os.path.join(path, cls._DICT_FILE), dict(extra))
        dist.barrier(device_ids=[torch.cuda.current_device()] if mesh.device_type == "cuda"
                     else None)
        return cls.from_directory(path)

    # -- accessors --------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """Full dict form. Round-trips every key: a directory checkpoint's
        state comes back whole, on the CPU, under 'torch_state'. Returns a
        copy so callers can't corrupt the checkpoint's internal dict."""
        if self._data is not None:
            return dict(self._data)
        data = _read_pickle(os.path.join(self._dir, self._DICT_FILE))
        state_dir = os.path.join(self._dir, _STATE_DIR)
        if os.path.isdir(state_dir):
            data[_STATE_KEY] = _load_state(state_dir)
        return data

    def to_directory(self, path: Optional[str] = None) -> str:
        path = path or tempfile.mkdtemp(prefix="raytpu-ckpt-")
        os.makedirs(path, exist_ok=True)
        if self._dir is not None:
            if os.path.abspath(self._dir) != os.path.abspath(path):
                shutil.copytree(self._dir, path, dirs_exist_ok=True)
            return path
        data = dict(self._data)
        state = data.pop(_STATE_KEY, None)
        if state is not None:
            _save_state(os.path.join(path, _STATE_DIR), state)
        _write_pickle(os.path.join(path, self._DICT_FILE), data)
        return path

    @contextmanager
    def as_directory(self):
        owned = self._dir is None
        path = self.to_directory()
        try:
            yield path
        finally:
            if owned:
                shutil.rmtree(path, ignore_errors=True)

    def get_torch_state(self, target=None, placements=None, mesh=None):
        """The saved state.

        - `target`: a state of the same tree to restore into: its tensors
          are filled in place (on their devices) and returned in the tree
          with the checkpoint's other leaves.
        - `placements` and `mesh`: every rank of the mesh calls this and
          gets its shards of each tensor under `placements` (as for
          from_torch_state_sharded), on the mesh's device; a directory
          checkpoint reads only those shards from disk, so a state saved
          under one strategy restores under another. With `target` too, the
          target holds those shards.
        - neither: the whole state, on the CPU.
        """
        if (placements is None) != (mesh is None):
            raise ValueError("pass placements and mesh together")
        if self._dir is not None:
            state_dir = os.path.join(self._dir, _STATE_DIR)
            if not os.path.isdir(state_dir):
                raise ValueError(f"checkpoint {self._dir!r} holds no torch state")
            return _load_state(state_dir, target, placements, mesh)
        if _STATE_KEY not in self._data:
            raise ValueError("checkpoint holds no torch state")
        state = self._data[_STATE_KEY]
        if mesh is None:
            state = _to_host(state)
        else:
            places = dict(_flatten(placements))
            device = _mesh_device(mesh)

            def shard(key, x):
                if not isinstance(x, torch.Tensor):
                    return copy.deepcopy(x)
                t = shard_tensor(x, places.get(key, ()), mesh)
                return t.to(device, copy=True).requires_grad_(x.requires_grad)

            state = _map_leaves(state, shard)
        if target is None:
            return state
        loaded = dict(_flatten(state))
        with torch.no_grad():
            return _map_leaves(_merge(target, state), lambda k, x: (
                x.copy_(loaded[k]) if isinstance(x, torch.Tensor) else x))

    def __repr__(self):
        kind = "dict" if self._data is not None else f"dir={self._dir!r}"
        return f"Checkpoint({kind}, id={self.id})"


class _Tensor:
    """Where a tensor of the state stood, in the pickled tree."""

    def __init__(self, key: str, requires_grad: bool):
        self.key = key
        self.requires_grad = requires_grad


def _map_leaves(tree, fn, prefix: str = ""):
    """The tree (nested dicts and lists) with each leaf x replaced by
    fn(dotted key, x); tuples are leaves, as placements are."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _flatten(tree) -> list:
    """(dotted key, leaf) pairs of a tree, in order."""
    out = []
    _map_leaves(tree, lambda k, x: out.append((k, x)))
    return out


def _merge(target, saved):
    """The saved tree with each tensor in it replaced by the target's at its
    key; every other leaf the saved one."""
    if isinstance(saved, dict):
        return {k: _merge(target[k], v) for k, v in saved.items()}
    if isinstance(saved, list):
        if len(target) != len(saved):
            raise ValueError(f"target has a list of {len(target)} where the checkpoint "
                             f"holds {len(saved)}")
        return [_merge(t, v) for t, v in zip(target, saved)]
    if isinstance(saved, (torch.Tensor, _Tensor)):
        if not isinstance(target, torch.Tensor):
            raise ValueError(f"target has {type(target).__name__} where the checkpoint "
                             "holds a tensor")
        return target
    return saved


def _to_host(state):
    """A host copy of every tensor, a deep copy of every other leaf (a
    generator's state must not follow the live one)."""
    def host(_, x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True).requires_grad_(x.requires_grad)
        return copy.deepcopy(x)

    return _map_leaves(state, host)


def _spans_world(mesh) -> None:
    """A sharded save or load is a collective of the default process group
    (DCP's, the pickle's one writer at rank 0, the barrier), so its mesh
    must hold every rank."""
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh holds {mesh.size()} of the {dist.get_world_size()} ranks; "
                         "a sharded checkpoint needs a mesh over all of them")


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _dtensor_placements(place, mesh):
    """A `Placement` (per tensor dim, the mesh axes that split it, major
    first) as DTensor placements (per mesh dim, Shard(d) or Replicate()).
    DTensor splits a dim over several mesh dims major-first in the mesh's
    order, so the axes of a dim must come in that order."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(place):
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"dim {d} is split over {axes}, not in the mesh's order {names}")
        for i in order:
            out[i] = Shard(d)
    return out


def _local_shape(shape, place, mesh) -> list:
    sizes = mesh_axis_sizes(mesh)
    shape = list(shape)
    for d, axes in enumerate(place):
        for a in axes:
            if shape[d] % sizes[a]:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {axes}")
            shape[d] //= sizes[a]
    return shape


def _save_state(path: str, state, mesh=None, placements=None) -> None:
    """DCP writes the state's tensors under `path`, and the tree beside
    them: with a mesh, each rank's shards as DTensors (a collective of the
    mesh's ranks; rank 0 writes the tree); without, this process's tensors
    whole (a local save)."""
    if mesh is not None:
        _spans_world(mesh)
    places = dict(_flatten(placements)) if placements is not None else {}
    tensors = {}

    def keep(key, x):
        if not isinstance(x, torch.Tensor):
            return x
        t = x.detach()
        if mesh is not None:
            t = DTensor.from_local(t, mesh, _dtensor_placements(places.get(key, ()), mesh),
                                   run_check=False)
        tensors[key] = t
        return _Tensor(key, x.requires_grad)

    tree = _map_leaves(state, keep)
    with _local(mesh):
        dcp.save(tensors, checkpoint_id=path, no_dist=mesh is None)
    if mesh is None or dist.get_rank() == 0:
        _write_pickle(os.path.join(path, _TREE_FILE), tree)


def _load_state(path: str, target=None, placements=None, mesh=None):
    """The state saved under `path`, its tensors read by DCP into the
    target's tensors, or into new ones: whole on the CPU, or with a mesh
    this rank's shards under `placements` on the mesh's device (a
    collective of the mesh's ranks)."""
    if mesh is not None:
        _spans_world(mesh)
    tree = _read_pickle(os.path.join(path, _TREE_FILE))
    if target is not None:
        tree = _merge(target, tree)
    places = dict(_flatten(placements)) if placements is not None else {}
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    device = _mesh_device(mesh) if mesh is not None else torch.device("cpu")
    tensors = {}

    def fill(key, x):
        if isinstance(x, _Tensor):
            m = meta[key]
            shape = m.size if mesh is None else _local_shape(m.size, places.get(key, ()), mesh)
            t = torch.empty(shape, dtype=m.properties.dtype, device=device)
        elif isinstance(x, torch.Tensor):
            t = x
        else:
            return x
        tensors[key] = t.detach() if mesh is None else DTensor.from_local(
            t.detach(), mesh, _dtensor_placements(places.get(key, ()), mesh), run_check=False)
        return t.requires_grad_(x.requires_grad) if isinstance(x, _Tensor) else t

    state = _map_leaves(tree, fill)
    with _local(mesh):
        dcp.load(tensors, checkpoint_id=path, no_dist=mesh is None)
    return state


@contextmanager
def _local(mesh):
    """DCP warns at every single-process save or load that it assumes one;
    without a mesh that is what is meant."""
    with warnings.catch_warnings():
        if mesh is None:
            warnings.filterwarnings("ignore", message=".*assuming the intent is to (save|load) "
                                    "in a single process")
        yield


def _write_pickle(path: str, obj) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def _read_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)
