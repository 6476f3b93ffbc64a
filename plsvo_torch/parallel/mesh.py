"""The port's device mesh: named axes over torch devices, one reduction,
and per-shard trees.

The JAX package drives a `jax.sharding.Mesh` with `shard_map` from one
controller: one process holds every device of a host, and a program runs
on each shard of the mesh. `Mesh` here is that single-controller mesh.
Each shard is a torch device, and a device may appear more than once
(several shards on one card, or the eight CPU shards the tests use). When
one axis spans processes (a (dcn, ici) mesh under a live
`torch.distributed` group), each process holds its own row of that axis
and reductions over it go through `torch.distributed.all_reduce`.

It is not `torch.distributed.DeviceMesh`: that class takes one process
per device, so it can express neither the single-controller mesh of the
JAX package nor several shards on one device.

A batch split over an axis lives as `Shards`: one tree per local shard, in
shard order, each on its shard's device.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence

import numpy as np
import torch


def normalize_device(d) -> torch.device:
    """torch.device(d), with a card's index made explicit (a bare "cuda"
    names the current card), so devices compare by identity."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _object_array(devices):
    """A nested list of devices as a numpy object array of its shape."""
    shape = []
    x = devices
    while isinstance(x, (list, tuple, np.ndarray)):
        shape.append(len(x))
        x = x[0]
    arr = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        x = devices
        for i in idx:
            x = x[i]
        arr[idx] = normalize_device(x)
    return arr


def on_device(dev: torch.device):
    """Make `dev` the current card while a shard's work is queued (ops that
    create tensors on "cuda" without an index, and the kernels' C entries,
    use the current card); a no-op for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class Mesh:
    """An n-D array of torch devices with named axes.

    `devices` is a nested list shaped like the mesh. `process_axis` names
    the axis that spans the processes of the live `torch.distributed`
    group (its size the group's world size): this process then holds the
    shards at its rank on that axis, and `group` is the group reductions
    over it use. Without it every shard is local."""

    def __init__(self, devices, axis_names: Sequence[str], *,
                 process_axis=None):
        self.devices = _object_array(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.process_axis = process_axis
        self.group = None
        coords = list(np.ndindex(*self.devices.shape))
        if process_axis is not None:
            import torch.distributed as dist

            world = dist.get_world_size() if dist.is_initialized() else 1
            if self.shape[process_axis] != world:
                raise ValueError(f"axis {process_axis!r} of size "
                                 f"{self.shape[process_axis]} spans {world} "
                                 "processes")
            self.group = dist.group.WORLD
            p = self.axis_names.index(process_axis)
            rank = dist.get_rank() if dist.is_initialized() else 0
            coords = [c for c in coords if c[p] == rank]
        self.local_coords = coords
        self.local_devices = [self.devices[c] for c in coords]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def index(self, shard: int, axes) -> int:
        """Local shard `shard`'s block along `axes` (row-major over them, as
        a PartitionSpec((a, b)) numbers the blocks)."""
        c = self.local_coords[shard]
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + c[self.axis_names.index(a)]
        return i

    def check_spans(self, axes):
        """Splitting over `axes` must cover the mesh: no shard holds a copy
        of another's rows."""
        if self.axis_size(axes) != self.size:
            raise ValueError(f"axes {_axes(axes)} of mesh {self.shape} leave "
                             "replicated shards; split over every axis of "
                             "size > 1")

    def psum(self, parts, axes):
        """Sum over `axes` of one tensor per local shard (in local shard
        order). Shards that differ only along `axes` sum together: the
        parts are added in shard order on the mesh's first local device,
        then all-reduced over the process group when one of `axes` spans
        processes. Returns one copy of its group's sum on each shard's
        device."""
        axes = _axes(axes)
        rest = [i for i, a in enumerate(self.axis_names) if a not in axes]
        first = self.local_devices[0]
        groups = {}
        for s, c in enumerate(self.local_coords):
            groups.setdefault(tuple(c[i] for i in rest), []).append(s)
        out = [None] * len(parts)
        for members in groups.values():
            total = parts[members[0]].to(first)
            for s in members[1:]:
                total = total + parts[s].to(first)
            if self.process_axis in axes and self.group is not None:
                import torch.distributed as dist

                if total is parts[members[0]]:
                    total = total.clone()  # all_reduce writes in place
                dist.all_reduce(total, group=self.group)
            for s in members:
                out[s] = total.to(self.local_devices[s])
        return out


def _axes(axes):
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Shards(list):
    """One tree per local shard of a batch split over a mesh axis, in shard
    order, each on its shard's device; every part holds the same number of
    rows of the leading axis. Reading an attribute reads it of every part
    (`step.pt_seeds` of a sharded step result is the Shards of the parts'
    seed tables), so a sharded result reads like an unsharded one."""

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return Shards(getattr(p, name) for p in self)

    def rows(self) -> int:
        """Rows per part: the leading size of the first part's first leaf."""
        return leaves(self[0])[0].shape[0]

    def locate(self, k: int):
        """(part, row within it) of global row k."""
        return divmod(k, self.rows())


def leaves(tree):
    """The tensors of a tree of tuples, lists and NamedTuples, in order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return []


def tree_map(fn, tree):
    """fn over every tensor of a tree of tuples, lists and NamedTuples
    (None and other leaves pass through; a Shards stays a Shards)."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        vals = [tree_map(fn, t) for t in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return tree


def split_rows(tree, mesh: Mesh, axis):
    """Shards of a tree whose tensors carry a leading batch axis: local
    shard s takes the rows of its block along `axis`, on its device."""
    mesh.check_spans(axis)
    B = leaves(tree)[0].shape[0]
    n = mesh.axis_size(axis)
    if B % n:
        raise ValueError(f"batch {B} not divisible by mesh axis {axis} of {n}")
    Bl = B // n
    parts = []
    for s, dev in enumerate(mesh.local_devices):
        lo = mesh.index(s, axis) * Bl
        parts.append(tree_map(lambda a: a[lo:lo + Bl].to(dev), tree))
    return Shards(parts)


def row(tree, k: int):
    """Row k of a stacked tree, or of a Shards (on its shard's device)."""
    if isinstance(tree, Shards):
        s, j = tree.locate(k)
        return tree_map(lambda a: a[j], tree[s])
    return tree_map(lambda a: a[k], tree)


def set_row(tree, k: int, value):
    """The stacked tree (or Shards) with row k replaced by `value`'s
    tensors, moved to the row's device."""
    if isinstance(tree, Shards):
        s, j = tree.locate(k)
        parts = list(tree)
        parts[s] = set_row(parts[s], j, value)
        return Shards(parts)
    return type(tree)(*[torch.cat([S[:k], v[None].to(S.device), S[k + 1:]])
                        for S, v in zip(tree, value)])


def unshard(tree):
    """A tree with every Shards in it replaced by its parts concatenated
    along the leading axis (numpy leaves on the host; tensors on the first
    part's device)."""
    if isinstance(tree, Shards):
        return _concat([unshard(p) for p in tree])
    if isinstance(tree, (tuple, list)):
        vals = [unshard(t) for t in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return tree


def _concat(parts):
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, np.ndarray):
        return np.concatenate(parts)
    if torch.is_tensor(first):
        return torch.cat([p.to(first.device) for p in parts])
    vals = [_concat(list(xs)) for xs in zip(*parts)]
    return type(first)(*vals) if hasattr(first, "_fields") else type(first)(vals)
