"""The device mesh and its sharding rules over `torch.distributed`
(counterpart of `vitiq/parallel/mesh.py`).

A `Mesh` lays the ranks of the process group out as vitiq lays out its
devices: an array of rank numbers, row-major over the axes ``("data",
"model")`` (`make_mesh`) or ``("dcn_data", "data", "model")``
(`make_multislice_mesh`). Every rank is one process driving one device.

  * data axes: the batch is split over them (`batch_sharding`: rank r takes
    the rows of its linear data index); the train step all-reduces its flat
    gradient over the data group once (`train/loop.py`).
  * model: Megatron tensor parallelism. The column-parallel projections
    (w_q, w_k, w_v, linear1) split the torch weight [out, in] on dim 0 and
    their bias on dim 0, so head h keeps rows h*dh:(h+1)*dh, as vitiq's
    ``P(None, "model")`` splits its [in, out] kernel; the row-parallel ones
    (w_concat, linear2) split dim 1 and keep their bias whole. A layer then
    needs one all-reduce after attention and one after the FFN
    (`models/layers.py`).

`shard_model` slices a model built whole (from its seed, as one process
builds it) in place to the rank's shards and records the mesh on the model,
where the encoder reads it. `full_state_dict` / `full_train_state` gather
the shards back (an all-reduce of a zeroed buffer over the model group:
gloo takes CUDA tensors only for broadcast and all-reduce), so checkpoints
keep vitiq's full-parameter layout under any mesh.

The mesh's process groups (`Mesh.data_group`, `Mesh.model_group`) are made
on first use; every rank must make that first use at the same point
(`dist.new_group` is called by all ranks, in one order). An axis of one
rank has no group (None), and its collectives are no-ops.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from vitiq_torch.parallel import comm

COLUMN_PARALLEL = ("w_q", "w_k", "w_v", "linear1")
ROW_PARALLEL = ("w_concat", "linear2")


class Mesh:
    """Rank numbers laid out over named axes; `rank` is this process's."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 rank: Optional[int] = None):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.rank = comm.rank() if rank is None else rank
        self._groups = None

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    def __deepcopy__(self, memo):  # process groups are shared, never copied
        return self

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def data_size(self) -> int:
        return math.prod(n for a, n in self.shape.items() if a != "model")

    @property
    def model_size(self) -> int:
        return self.shape.get("model", 1)

    def _grid(self) -> np.ndarray:
        """[data ranks, model ranks]: row i holds the model ranks of data
        index i."""
        return self.devices.reshape(-1, self.model_size)

    def _where(self, rank: Optional[int]):
        rank = self.rank if rank is None else rank
        hit = np.argwhere(self._grid() == rank)
        if not len(hit):
            raise ValueError(f"rank {rank} is not in mesh {self.shape}")
        return hit[0]

    def data_index(self, rank: Optional[int] = None) -> int:
        """The rank's linear index over the data axes, in axis order."""
        return int(self._where(rank)[0])

    def model_index(self, rank: Optional[int] = None) -> int:
        return int(self._where(rank)[1])

    def data_src(self) -> int:
        """The global rank of data index 0 in this rank's data group."""
        return int(self._grid()[0, self.model_index()])

    def _make_groups(self):
        if self._groups is None:
            import torch.distributed as dist

            grid = self._grid()

            def group(ranks):
                return dist.new_group([int(r) for r in ranks]) if len(ranks) > 1 else None

            data = [group(grid[:, j]) for j in range(grid.shape[1])]
            model = [group(grid[i]) for i in range(grid.shape[0])]
            self._groups = (data, model)
        return self._groups

    @property
    def data_group(self):
        """The ranks of this rank's model index over the data axes."""
        if self.data_size == 1:
            return None
        return self._make_groups()[0][self.model_index()]

    @property
    def model_group(self):
        """The ranks of this rank's data index over the model axis."""
        if self.model_size == 1:
            return None
        return self._make_groups()[1][self.data_index()]


def _ranks(devices: Optional[Sequence[int]]) -> list:
    return list(devices) if devices is not None else list(range(comm.world_size()))


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """A (data, model) mesh of the ranks `devices` (default: every rank of
    the process group, or the one process). Defaults to all of them on the
    data axis."""
    devices = _ranks(devices)
    if data is None:
        data = len(devices) // model
    n = data * model
    if n > len(devices):
        raise ValueError(f"mesh {data}x{model} needs {n} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n]).reshape(data, model), ("data", "model"))


def make_multislice_mesh(dcn_data: int, ici_data: Optional[int] = None, model: int = 1,
                         devices: Optional[Sequence[int]] = None) -> Mesh:
    """The ("dcn_data", "data", "model") mesh, the batch split over both data
    axes jointly, derived and checked as vitiq derives it. Ranks carry no
    slice topology, so the layout is vitiq's plain reshape."""
    devices = _ranks(devices)
    if ici_data is None:
        ici_data = len(devices) // (dcn_data * model)
    if ici_data < 1:
        raise ValueError(
            f"multislice mesh dcn_data={dcn_data} x model={model} leaves no "
            f"devices for the ICI data axis ({len(devices)} devices total)")
    n = dcn_data * ici_data * model
    if n > len(devices):
        raise ValueError(
            f"multislice mesh {dcn_data}x{ici_data}x{model} needs {n} devices, "
            f"have {len(devices)}")
    return Mesh(np.array(devices[:n]).reshape(dcn_data, ici_data, model),
                ("dcn_data", "data", "model"))


def mesh_data_axes(mesh: Mesh) -> tuple:
    """Axis names carrying the batch dimension with size > 1."""
    return tuple(a for a in mesh.axis_names if a != "model" and mesh.shape[a] > 1)


def process_local_rows(mesh: Mesh, global_batch: int, process_index: Optional[int] = None,
                       process_of_device=None) -> slice:
    """Rows of the global batch owned by one process's ranks: each rank
    holds the `global_batch / data ranks` rows of its linear data index
    (its model-axis peers the same rows). `process_of_device` maps a rank to
    its process (default: each rank is its own process) and
    `process_index` defaults to this rank; the rows of one process must be
    contiguous."""
    if process_of_device is None:
        def process_of_device(d):
            return d
    if process_index is None:
        process_index = mesh.rank
    n_data = mesh.data_size
    if global_batch % n_data:
        raise ValueError(f"a batch of {global_batch} rows does not divide over the mesh's "
                         f"data axes {mesh.shape}")
    per = global_batch // n_data
    spans = sorted({(mesh.data_index(int(d)) * per, (mesh.data_index(int(d)) + 1) * per)
                    for d in mesh.devices.flat if process_of_device(int(d)) == process_index})
    if not spans:
        raise ValueError(f"process {process_index} owns no devices of mesh {mesh.shape}")
    lo, hi = spans[0][0], max(e for _, e in spans)
    cur = lo
    for s, e in spans:
        if s > cur:
            raise ValueError(
                f"process {process_index}'s batch rows are non-contiguous "
                f"({spans}); feed assembly needs one host slice per process "
                f"— reorder the mesh so same-process devices are adjacent "
                f"on the data axis")
        cur = max(cur, e)
    return slice(lo, hi)


def batch_sharding(mesh: Mesh, global_batch: int, rank: Optional[int] = None) -> slice:
    """The rank's rows of a batch of `global_batch` rows."""
    return process_local_rows(mesh, global_batch, process_index=rank)


def shard_batch(batch, mesh: Mesh, rank: Optional[int] = None):
    """The rank's rows of a host batch: an array, or a tuple / list / dict of
    arrays with one leading batch axis."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, rank) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh, rank) for v in batch)
    return batch[batch_sharding(mesh, len(batch), rank)]


def replicated_sharding(mesh: Optional[Mesh] = None) -> None:
    """The split of a parameter kept whole on every rank: none."""
    return None


def _spec_for(name: str) -> Optional[int]:
    """The dim of a `state_dict` entry split over the model axis, or None
    (vitiq's `_spec_for` on the torch layout: see the module docstring)."""
    parts = name.split(".")
    if len(parts) >= 2:
        owner, leaf = parts[-2], parts[-1]
        if owner in COLUMN_PARALLEL:
            return 0
        if owner in ROW_PARALLEL:
            return 1 if leaf == "weight" else None
    return None


def param_shardings(mesh: Optional[Mesh], model_or_state_dict) -> Dict[str, Optional[int]]:
    """{state_dict name: the dim split over the model axis, or None}."""
    sd = (model_or_state_dict.state_dict() if isinstance(model_or_state_dict, nn.Module)
          else model_or_state_dict)
    return {name: _spec_for(name) for name in sd}


def _slice(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    n = t.shape[dim] // mesh.model_size
    return t.narrow(dim, mesh.model_index() * n, n).clone()


def shard_model(model: nn.Module, mesh: Mesh, state=None):
    """Slice `model` (built whole) in place to this rank's shards under the
    TP rules and record `mesh` on it (``model.mesh`` and its encoder's). A
    TrainState built on the whole model (`state`) has its AdamW moments
    sliced the same way, and is returned; so is None. Under a model axis
    above 1, n_head and ffn_hidden must divide by it. A model already
    sharded over `mesh` is left as it is; one sharded over another mesh's
    model axis raises."""
    old = getattr(model, "mesh", None)
    if old is mesh:
        return state
    if old is not None and old.model_size > 1:
        raise ValueError(f"the model is already sharded over {old}; build it whole to shard "
                         f"it over {mesh}")
    if mesh.model_size > 1:
        cfg = model.cfg
        if cfg.n_head % mesh.model_size or cfg.ffn_hidden % mesh.model_size:
            raise ValueError(f"tensor parallelism over {mesh.model_size} ranks needs n_head "
                             f"({cfg.n_head}) and ffn_hidden ({cfg.ffn_hidden}) divisible "
                             f"by it")
        named = list(model.named_parameters())
        if state is not None:
            opt = state.opt_state
            mu, nu = (_shard_flat(v, named, mesh) for v in (opt.mu, opt.nu))
            state = state._replace(opt_state=opt._replace(mu=mu, nu=nu))
        with torch.no_grad():
            for name, p in named:
                dim = _spec_for(name)
                if dim is not None:
                    p.data = _slice(p.data, dim, mesh)
    model.mesh = mesh
    if hasattr(model, "encoder"):
        model.encoder.mesh = mesh
    return state


def shard_state_dict(state_dict, model: nn.Module) -> Dict[str, torch.Tensor]:
    """A whole state dict sliced to the shards of `model`'s mesh (itself
    without a model axis above 1)."""
    mesh = model_mesh(model)
    if mesh is None or mesh.model_size == 1:
        return dict(state_dict)
    return {n: t if _spec_for(n) is None else _slice(t, _spec_for(n), mesh)
            for n, t in state_dict.items()}


def shard_params(model: nn.Module, mesh: Mesh, state=None):
    """vitiq's name for `shard_model`."""
    return shard_model(model, mesh, state)


def _shard_flat(flat: torch.Tensor, named, mesh: Mesh) -> torch.Tensor:
    """A vector flat over the whole model's parameters -> over the shards."""
    pieces = flat.split([p.numel() for _, p in named])
    out = []
    for (name, p), piece in zip(named, pieces):
        dim = _spec_for(name)
        piece = piece.view(p.shape)
        out.append((piece if dim is None else _slice(piece, dim, mesh)).reshape(-1))
    return torch.cat(out)


def model_mesh(model: nn.Module) -> Optional[Mesh]:
    return getattr(model, "mesh", None)


def _gather(tensors: Dict[str, torch.Tensor], full_shapes: Dict[str, torch.Size],
            mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Whole tensors from the model group's shards: one all-reduce of the
    zeroed whole buffers, each holding this rank's shard in its place."""
    names = [n for n in tensors if _spec_for(n) is not None]
    if not names:
        return dict(tensors)
    device = tensors[names[0]].device
    bufs = []
    for n in names:
        buf = torch.zeros(full_shapes[n], dtype=torch.float32, device=device)
        dim, t = _spec_for(n), tensors[n]
        buf.narrow(dim, mesh.model_index() * t.shape[dim], t.shape[dim]).copy_(t)
        bufs.append(buf.reshape(-1))
    flat = comm.all_reduce_(torch.cat(bufs), mesh.model_group)
    out = dict(tensors)
    for n, piece in zip(names, flat.split([b.numel() for b in bufs])):
        out[n] = piece.view(full_shapes[n]).to(tensors[n].dtype)
    return out


def _full_shapes(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Size]:
    shapes = {}
    for name, t in model.state_dict().items():
        dim = _spec_for(name)
        shape = list(t.shape)
        if dim is not None:
            shape[dim] *= mesh.model_size
        shapes[name] = torch.Size(shape)
    return shapes


def full_state_dict(model: nn.Module, state_dict=None) -> Dict[str, torch.Tensor]:
    """The whole parameters of a sharded model (`state_dict`: a state dict
    of its shards, default the model's own). A collective under a model
    axis above 1: every rank of the model group calls it."""
    sd = dict(model.state_dict() if state_dict is None else state_dict)
    mesh = model_mesh(model)
    if mesh is None or mesh.model_size == 1:
        return sd
    return _gather(sd, _full_shapes(model, mesh), mesh)


def full_train_state(state):
    """The TrainState of a sharded model with its parameters and AdamW
    moments whole, on the CPU (a whole `AMCModel` of the config); the state
    itself under a model axis of 1. A collective like `full_state_dict`."""
    model = state.model
    mesh = model_mesh(model)
    if mesh is None or mesh.model_size == 1:
        return state
    from vitiq_torch.models.amc import AMCModel

    shapes = _full_shapes(model, mesh)
    whole = AMCModel(model.cfg, generator=torch.Generator().manual_seed(0))
    whole.load_state_dict({k: v.cpu() for k, v in full_state_dict(model).items()})
    named = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    opt = state.opt_state
    moments = []
    for flat in (opt.mu, opt.nu):
        pieces = flat.split([params[n].numel() for n in named])
        local = {n: piece.view(params[n].shape) for n, piece in zip(named, pieces)}
        full = _gather(local, shapes, mesh)
        moments.append(torch.cat([full[n].reshape(-1) for n in named]).cpu())
    opt = opt._replace(mu=moments[0], nu=moments[1], learning_rate=opt.learning_rate.cpu(),
                       count=opt.count.cpu(), corrections=())
    return state._replace(model=whole, opt_state=opt, step=state.step.cpu())
