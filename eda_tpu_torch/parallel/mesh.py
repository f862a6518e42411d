"""Data and tensor parallelism over ``torch.distributed`` (counterpart of ``eda_tpu/parallel/mesh.py``).

The JAX package compiles one global-view step over a ``('data', 'model')``
device mesh and lets XLA derive the collectives. PyTorch's idiom is one
process per card (``torchrun``), so the port writes them out, and a step of
W data ranks, each holding B / W rows, computes what the global step computes
over the B rows:

* the batch: data rank d holds rows [d B / W, (d + 1) B / W) of every global
  batch (``process_batch_rows``), as ``batch_sharding`` places them;
* BatchNorm statistics: the sums over the rows are all-reduced over the
  ``data`` group (``global_sum``, whose backward all-reduces the gradients);
* dropout: every rank draws the mask of the global batch and keeps its rows
  (``models/layers.py:Dropout``);
* the loss: each rank's loss is its share of the global loss, with
  ``num_boxes`` summed over the group (``losses/criterion.py``), so the
  gradients are SUMMED over the group (``all_reduce_grads``) and the metrics
  are the sums of the shares;
* tensor parallelism over the ``model`` axis, Megatron-style
  (``tp_param_spec``): attention heads and FFN hidden units are split,
  ``copy_to_model`` enters a split block (identity forward, all-reduced
  gradient) and ``reduce_from_model`` leaves it (all-reduced forward,
  identity gradient);
* checkpoints hold full tensors on any mesh (``train/checkpoint.py``).

Rank layout: JAX's grid ``reshape(data, model)``, so rank = d * model + m
and the model ranks of one data index share its rows. Every group is made
with a timeout, so a collective that one rank never reaches fails instead
of hanging. The backend is NCCL for CUDA and gloo for the CPU unless the
caller names one; gloo's CUDA support does not cover every collective, so a
gloo mesh on CUDA tensors stages every collective through host memory.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=300)
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place on a (data, model) grid of processes and the groups of its two axes.

    ``data_group`` holds the ranks that share this rank's model index (one per
    data index, in data order); ``model_group`` those that share its data
    index (None when ``model`` is 1).
    """

    data: int
    model: int
    rank: int
    device: torch.device
    backend: str
    data_group: object = None
    model_group: object = None

    def __deepcopy__(self, memo):
        return self  # a handle on the communicators, shared by copies of a state

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def staged(self) -> bool:
        """Collectives go through host memory (gloo on CUDA tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _group(self, axis: str):
        return self.data_group if axis == "data" else self.model_group

    def all_reduce_(self, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """Sum ``x`` over the ranks of ``axis`` in place; returns ``x``."""
        if self.staged:
            host = x.cpu()
            dist.all_reduce(host, group=self._group(axis))
            return x.copy_(host)
        dist.all_reduce(x, group=self._group(axis))
        return x

    def all_gather(self, x: torch.Tensor, axis: str = "data") -> list:
        """Every rank's ``x`` along ``axis``, in rank order (on the host under gloo)."""
        n = self.data if axis == "data" else self.model
        src = (x.cpu() if self.backend == "gloo" else x.to(self.device)).contiguous()
        out = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(out, src, group=self._group(axis))
        return out

    def gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order, on every rank."""
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        dist.barrier()


def init_process_group(rank: int, world_size: int, init_method: str, backend: Optional[str] = None,
                       device="cpu", timeout: datetime.timedelta = TIMEOUT) -> None:
    """``torch.distributed.init_process_group`` with the port's default backend and a
    timeout; an NCCL rank is bound to its card (``device_id``), so NCCL never
    guesses the card from the rank."""
    backend = backend or default_backend(device)
    bind = {"device_id": torch.device(device)} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=timeout, **bind)


def torchrun_env() -> bool:
    """True when torchrun's variables describe this process."""
    return all(v in os.environ for v in TORCHRUN_VARS)


def init_from_env(cpu: bool = False) -> Mesh:
    """The data-parallel mesh of a process that torchrun started
    (``torchrun --nproc_per_node N ...``; model = 1, as ``train.py``'s).

    Reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``; the rank's device is
    ``cuda:LOCAL_RANK`` (NCCL), or the CPU (gloo) with ``cpu``. The
    counterpart of ``jax.distributed.initialize()`` under ``EDA_TPU_MULTIHOST``.
    """
    missing = [v for v in TORCHRUN_VARS if v not in os.environ]
    if missing:
        raise SystemExit(f"a multi-process run takes its ranks from torchrun, and {missing} are "
                         "not set: launch it as torchrun --nproc_per_node N -m "
                         "eda_tpu_torch.train ... (--nnodes / --node_rank / --master_addr "
                         "for several hosts)")
    local_rank = int(os.environ["LOCAL_RANK"])
    if cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --cpu to run the ranks on the CPU")
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", local_rank + 1))
        if local_world > torch.cuda.device_count():
            raise SystemExit(f"{local_world} ranks on this host but {torch.cuda.device_count()} "
                             "CUDA device(s): NCCL takes one card per rank, so two ranks "
                             "cannot share a card; start at most one rank per card")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    init_process_group(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://",
                       device=device)
    return make_mesh(device=device)


def make_mesh(data: Optional[int] = None, model: int = 1, device=None,
              timeout: datetime.timedelta = TIMEOUT) -> Mesh:
    """The ('data', 'model') mesh over the initialised world, in the world's
    backend (``init_process_group`` names it); every rank calls it.

    Args:
        data: data-parallel size; defaults to world size // model.
        model: tensor-parallel size.
        device: this rank's device; defaults to the current CUDA device
            under NCCL, else the CPU.
    """
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh data={data} x model={model} != world size {world}")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    grid = np.arange(world).reshape(data, model)
    mesh = Mesh(data, model, rank, torch.device(device), backend)
    # every rank creates every group, in one order
    for m in range(model):
        group = dist.new_group(grid[:, m].tolist(), timeout=timeout, backend=backend)
        if rank in grid[:, m]:
            mesh.data_group = group
    if model > 1:
        for d in range(data):
            group = dist.new_group(grid[d].tolist(), timeout=timeout, backend=backend)
            if rank in grid[d]:
                mesh.model_group = group
    return mesh


class _GlobalSum(torch.autograd.Function):
    """Sum over the data group; the gradient of each rank's input is the sum of
    the ranks' output gradients (each rank's loss is a share of the total)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone(), "data")

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.clone(), "data"), None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient is summed over the model group."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.clone(), "model"), None


class _ReduceFromModel(torch.autograd.Function):
    """Partial products summed over the model group; identity gradient (every
    model rank holds the whole output and the same loss)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_(x.clone(), "model")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the data group, differentiably."""
    return _GlobalSum.apply(x, mesh)


def copy_to_model(mesh: Mesh, *xs: torch.Tensor) -> tuple:
    """The inputs of a split block; one tensor passed twice stays one tensor."""
    out = {}
    for x in xs:
        if id(x) not in out:
            out[id(x)] = _CopyToModel.apply(x, mesh)
    return tuple(out[id(x)] for x in xs)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)


def all_reduce_grads(mesh: Mesh, params: Sequence[torch.nn.Parameter]) -> None:
    """Sum the parameters' gradients over the data group, as one flat buffer
    (a fixed order); parameters without a gradient are left so."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    mesh.all_reduce_(flat, "data")
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def sum_metrics(mesh: Mesh, metrics: dict) -> dict:
    """The ranks' 0-d metric shares summed over the data group (one collective)."""
    keys = sorted(metrics)
    total = mesh.all_reduce_(torch.stack([metrics[k].detach().float() for k in keys]), "data")
    return dict(zip(keys, total.unbind()))


def batch_rows_for_ranks(mesh: Mesh, data_ranks: Sequence[int], global_batch: int) -> np.ndarray:
    """Global-batch rows that the data ranks ``data_ranks`` hold, ascending: data
    rank d holds the contiguous block d of ``mesh.data`` equal blocks
    (``batch_rows_for_devices`` under ``batch_sharding``)."""
    if global_batch % mesh.data:
        raise ValueError(f"global batch {global_batch} does not divide over data={mesh.data}")
    per = global_batch // mesh.data
    rows = [np.arange(d * per, (d + 1) * per) for d in sorted(set(data_ranks))]
    return np.concatenate(rows) if rows else np.zeros(0, np.int64)


def process_batch_rows(mesh: Optional[Mesh], global_batch: int) -> np.ndarray:
    """This rank's rows of every global batch, the ``DistributedSampler``
    analogue: every rank draws the same epoch permutation and assembles only
    these rows. Without a mesh, all rows."""
    if mesh is None:
        return np.arange(global_batch)
    return batch_rows_for_ranks(mesh, [mesh.data_rank], global_batch)


def make_global_batch(local_batch: dict, mesh: Mesh, global_batch: int) -> dict:
    """The rank's part of a global batch: its ``process_batch_rows`` rows of a
    numpy ``{"inputs", "targets"}`` batch as tensors on its device. PyTorch has
    no global array; the rows are the rank's shard of one."""
    per = global_batch // mesh.data
    out = {}
    for group, arrays in local_batch.items():
        out[group] = {}
        for k, v in arrays.items():
            if len(v) != per:
                raise ValueError(f"{group}/{k}: {len(v)} rows, this rank holds {per} of "
                                 f"{global_batch}")
            out[group][k] = torch.from_numpy(v).to(mesh.device)
    return out


def to_host_global(tree, mesh: Optional[Mesh] = None, axis: int = 0):
    """A numpy copy of a tree of per-rank tensors or arrays, concatenated along
    ``axis`` over the data group in data-rank order, on every rank (the
    reference's all_gather of evaluator state). Without a mesh, or with one
    data rank, a plain copy."""

    def one(x):
        t = torch.as_tensor(x).detach()
        if mesh is None or mesh.data == 1:
            return t.cpu().numpy()
        is_bool = t.dtype == torch.bool
        parts = mesh.all_gather(t.to(torch.uint8) if is_bool else t, "data")
        out = torch.cat([p.cpu() for p in parts], axis).numpy()
        return out.astype(bool) if is_bool else out

    if isinstance(tree, dict):
        return {k: to_host_global(v, mesh, axis) for k, v in tree.items()}
    return one(tree)


# the leaves of tp_param_spec, by the port's parameter names
_ATTN = re.compile(r"(^|\.)(attn|attention)\.(query|key|value|out)\.(weight|bias)$")
_COLUMN = re.compile(r"(^|\.)(ffn[^.]*\.dense\.0|intermediate)\.(weight|bias)$")
_ROW = re.compile(r"(^|\.)(ffn[^.]*\.dense\.1|output)\.weight$")


def tp_param_spec(name: str) -> Optional[int]:
    """The dimension over which a parameter splits across the model group, or None.

    Weights are (out, in). Attention splits its heads: the q / k / v weights'
    rows and biases, and the out projection's columns (its bias replicates).
    FFNs (the ``ffn*`` blocks' ``dense.0`` / ``dense.1`` and RoBERTa's
    ``intermediate`` / ``output``) split column-wise then row-wise: the first
    weight's rows and bias, the second weight's columns. Everything else
    replicates. The leaves are those of the JAX package's ``tp_param_spec``.
    """
    attn = _ATTN.search(name)
    if attn:
        if attn.group(3) != "out":
            return 0
        return 1 if attn.group(4) == "weight" else None
    if _COLUMN.search(name):
        return 0
    if _ROW.search(name):
        return 1
    return None


def _check_tp_coverage(model: torch.nn.Module, model_size: int) -> None:
    """Fail LOUDLY if the TP rules stopped matching the parameter names.

    ``tp_param_spec`` matches names; a module rename would silently de-shard
    weights (still right, quietly ``model_size`` x the memory and compute).
    Rename-proof invariants, as the JAX package's:

    * every projection weight of every ``MultiHeadAttention`` (found by type,
      not by name) must split;
    * among the other weights, both a column-parallel (rows split) and a
      row-parallel (columns split) one must exist: the FFN pair;
    * at least 20% of the parameter bytes must split.
    """
    from eda_tpu_torch.models.layers import Dense, MultiHeadAttention

    attention = {f"{prefix}.{child}.weight" if prefix else f"{child}.weight"
                 for prefix, m in model.named_modules() if isinstance(m, MultiHeadAttention)
                 for child, sub in m.named_children() if isinstance(sub, Dense)}
    misses, sharded_bytes, total_bytes = [], 0, 0
    has_col = has_row = False
    for name, p in model.named_parameters():
        dim = tp_param_spec(name)
        nbytes = p.numel() * p.element_size()
        total_bytes += nbytes
        if dim is not None:
            sharded_bytes += nbytes
        if name in attention:
            if dim is None:
                misses.append(name)
        elif name.endswith("weight") and p.dim() == 2:
            has_col |= dim == 0
            has_row |= dim == 1
    problems = []
    if misses:
        problems.append(f"{len(misses)} attention projection weights got NO model-axis split "
                        f"(first: {misses[0]})")
    if not has_col or not has_row:
        problems.append(f"missing column- and/or row-parallel FFN weights "
                        f"(col={has_col}, row={has_row})")
    frac = sharded_bytes / max(total_bytes, 1)
    if frac < 0.20:
        problems.append(f"only {frac:.1%} of parameter bytes split over 'model'")
    if problems:
        raise ValueError(f"TP sharding coverage check failed with model={model_size}: "
                         + "; ".join(problems) + " — a module rename likely broke "
                         "tp_param_spec's name matching (eda_tpu_torch/parallel/mesh.py).")


def shard(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's part of a full tensor split ``mesh.model`` ways along ``dim``."""
    return t.chunk(mesh.model, dim)[mesh.model_rank].clone()


def gather_shards(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The full tensor of the model group's parts along ``dim``, on ``t``'s device."""
    return torch.cat([p.to(t.device) for p in mesh.all_gather(t, "model")], dim)


def sharded_names(model: torch.nn.Module, mesh: Optional[Mesh]) -> dict:
    """{parameter name: split dimension} of a model sharded on ``mesh``."""
    if mesh is None or mesh.model == 1:
        return {}
    return {n: d for n, _ in model.named_parameters() if (d := tp_param_spec(n)) is not None}


def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Put ``model`` on ``mesh`` for training, in place, once.

    Every ``BatchNorm`` then takes the statistics of the data group's global
    batch and every ``Dropout`` draws the global batch's mask (their
    ``mesh``). With ``model`` > 1 each leaf of ``tp_param_spec`` keeps this
    rank's part, and the attention, FFN and RoBERTa layers (their ``tp``) run
    their share of heads and hidden units; with ``model`` = 1 no parameter
    changes. Build the optimizer after, so that its moments take the parts'
    shapes. ``train.step.make_train_step(..., mesh=mesh)`` refuses a model
    that was not put on its mesh.
    """
    from eda_tpu_torch.models.layers import FFN, BatchNorm, Dropout, MultiHeadAttention
    from eda_tpu_torch.models.roberta import RobertaLayer

    if mesh.model > 1:
        _check_tp_coverage(model, mesh.model)
        for m in model.modules():
            if isinstance(m, MultiHeadAttention) and m.n_heads % mesh.model:
                raise ValueError(f"{m.n_heads} heads do not split over model={mesh.model}")
        with torch.no_grad():
            for name, p in model.named_parameters():
                dim = tp_param_spec(name)
                if dim is not None:
                    if p.shape[dim] % mesh.model:
                        raise ValueError(f"{name} {tuple(p.shape)} does not split over "
                                         f"model={mesh.model} along {dim}")
                    p.data = shard(p.data, dim, mesh)
    for m in model.modules():
        if isinstance(m, (BatchNorm, Dropout)):
            m.mesh = mesh
        if mesh.model > 1 and isinstance(m, (MultiHeadAttention, FFN, RobertaLayer)):
            m.tp = mesh
    model.mesh = mesh
    return model
