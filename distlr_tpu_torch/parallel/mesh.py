"""The port's mesh: axis sizes of the sync step's two kinds of parallelism.

Counterpart of ``distlr_tpu/parallel/mesh.py``.  There a mesh is a grid
of devices with named axes: ``data`` (the reference's W workers; their
gradients meet in a ``psum``) and ``model`` (the feature dimension cut
into S ranges, ps-lite's server key ranges).  Here the whole grid is one
card, so the mesh is a small value object of axis sizes:

* ``data`` — W contiguous row blocks of a global batch (worker i's rows
  are block i, the layout ``GlobalShardedData`` builds);
* ``model`` — S contiguous column blocks of the features and of w
  (``parallel.feature_parallel``).

Across processes the data axis spans every rank of a ``torch.distributed``
process group: each process holds ``W / P`` of the row blocks (rank r the
blocks ``r·W/P .. (r+1)·W/P − 1``) and the blocks' gradients meet in an
``all_reduce``, as JAX's global mesh spans the processes of
``jax.distributed``.  The ``model`` axis stays inside a process.

JAX's ``shard_map`` shim and its ``NamedSharding`` helpers
(``batch_sharding``, ``replicated_sharding``, ``feature_sharding``) have
no counterpart: a block is a view of one tensor on one card, so there is
nothing to place.
"""

from __future__ import annotations

import dataclasses

DATA_AXIS = "data"
MODEL_AXIS = "model"
_AXES = (DATA_AXIS, MODEL_AXIS)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes (``shape``, the data axis counted over every process),
    and the process group the data axis spans (None: this process
    alone)."""

    shape: dict
    group: object = None
    num_processes: int = 1
    process_index: int = 0

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def local_data_shards(self) -> int:
        """Row blocks this process holds."""
        return self.shape.get(DATA_AXIS, 1) // self.num_processes

    @property
    def first_data_shard(self) -> int:
        """Global index of this process's first row block."""
        return self.process_index * self.local_data_shards


def make_mesh(shape: dict | None = None, *, group=None) -> Mesh:
    """A mesh of ``shape`` (axis -> size, e.g. ``{"data": 4, "model": 2}``).

    ``shape["data"]`` is the global data axis, as JAX's ``make_mesh`` lays
    a shape over the global device list.  With a ``torch.distributed``
    process group of P ranks each process holds ``data / P`` of its row
    blocks; a data axis that P does not divide raises (the port's model
    axis stays inside a process, so no block is split across processes).
    Default: one row block a process, ``{"data": P}`` (JAX's default puts
    every device, one a process, on ``data``)."""
    num_processes, index = 1, 0
    if group is not None:
        import torch.distributed as dist  # noqa: PLC0415

        num_processes, index = dist.get_world_size(group), dist.get_rank(group)
    shape = dict(shape or {DATA_AXIS: num_processes})
    bad = [a for a in shape if a not in _AXES]
    if bad:
        raise ValueError(f"mesh axes must be among {_AXES}, got {list(shape)}")
    if any(int(v) < 1 for v in shape.values()):
        raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
    shape.setdefault(DATA_AXIS, 1)
    if shape[DATA_AXIS] % num_processes:
        raise ValueError(
            f"a data axis of {shape[DATA_AXIS]} row blocks does not split over "
            f"{num_processes} processes: make the data axis (--num-workers) a multiple of "
            "the process count (the model axis stays inside a process)")
    # data first, as JAX's meshes put it
    ordered = {a: int(shape[a]) for a in _AXES if a in shape}
    return Mesh(ordered, group, num_processes, index)


def axis_size(mesh: Mesh, axis_name: str) -> int:
    """Size of a named axis (1 for an axis the mesh lacks).  JAX's takes
    the name alone, inside a ``shard_map`` body; here the mesh is given."""
    return mesh.shape.get(axis_name, 1)


def num_data_shards(mesh: Mesh) -> int:
    """Row blocks of the data axis, over every process."""
    return axis_size(mesh, DATA_AXIS)


def as_mesh(mesh) -> Mesh:
    """A :class:`Mesh`, or an int W: W row blocks in this process."""
    if isinstance(mesh, Mesh):
        return mesh
    return make_mesh({DATA_AXIS: int(mesh)})
