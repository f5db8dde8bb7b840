"""Data parallelism: the data mesh and its collectives.

Counterpart of `invertavatar_tpu/parallel/mesh.py`. The JAX package runs one
program over a `Mesh(('data',))`, the batch sharded and the parameters
replicated. The port keeps the reference's hand-rolled data parallelism
rather than `torch.nn.parallel.DistributedDataParallel`, whose reducer fires
only on the `.backward()` of a wrapped `forward`: the steps here call the
mapping, synthesis and discriminator separately, form gradients with
`torch.autograd.grad`, take R1's double backward and step masked Adams by
hand. So rank 0's parameters, buffers and optimizer state are broadcast once
(`replicate`, reference training_loop.py:255-259), and after each phase's
backward one flat all-reduce of the gradients, divided by the world size,
runs before the NaN scrub (`all_reduce_grads`, training_loop.py:379-389).

On N ranks step i is the JAX mesh step: the arithmetic of one process on the
global batch, up to the order of float sums. Rank r holds the rows r, r + N,
r + 2N, ... of each global batch (`shard_batch`: the rows that
`InfiniteSampler(rank=r, num_replicas=N)` yields). Inside `use_mesh(mesh)`,
which the trainers' steps enter, the batch-wide parts of a step act on the
global batch:
  * `batch_rand` draws a per-item tensor over the global batch and keeps this
    rank's rows, so that each item gets the draws it gets in one process;
  * `gather_rows` assembles a per-item tensor over the global batch, with
    gradients (the minibatch-std layer, the conditioning swap's roll);
  * `mean_over_ranks`, `min_over_ranks` and `max_over_ranks` reduce a
    batch-wide statistic (the mapping's `w_avg`, the renderer's near/far).
A tensor whose leading axis is not the items alone ([chunk, item, frame]
rows of a clip) names its layout with `batch_layout`. Only `all_reduce` and
`broadcast` are used, so the same code runs over gloo (on the CPU, and on
CUDA tensors through the host) and over NCCL. At a world size of 1 every
collective still runs, and each is exact there.

The active mesh is context-local state (a `ContextVar`, as torch keeps its
grad mode), set only inside `use_mesh`: code outside a step, such as rank
0's snapshot renders and metrics, never reaches a collective.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Iterable, List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank's view of the data axis: its rank, the world size, the device
    its tensors live on and the process group (None: the default group)."""

    rank: int
    world_size: int
    device: torch.device
    group: Any = None


def make_mesh(device=None, group=None) -> DataMesh:
    """The data mesh over an initialised `torch.distributed` process group;
    `device` defaults to the current card under NCCL and the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group "
                           "(parallel.multihost.initialize_distributed)")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    return DataMesh(dist.get_rank(group), dist.get_world_size(group), torch.device(device),
                    group)


def _src(mesh: DataMesh) -> int:
    """The global rank of the group's rank 0."""
    return 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)


# ------------------------------------------------------------------ batches


def shard_batch(mesh: DataMesh, tree):
    """Rank `mesh.rank`'s rows of a global batch (arrays or tensors in nested
    dicts): the rows r, r + N, ... of each leading axis."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if tree.shape[0] % mesh.world_size:
        raise ValueError(f"a batch of {tree.shape[0]} does not split over "
                         f"{mesh.world_size} ranks")
    return tree[mesh.rank::mesh.world_size]


def _leading(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def local_batch(mesh: Optional[DataMesh], tree, global_size: int):
    """This rank's rows of a step's batch. `tree` holds either the global
    batch (`global_size` rows, cut by `shard_batch` as the JAX trainers cut
    theirs) or this rank's rows already (a loader sharded by rank, as the
    GAN CLI's). Without a mesh, `tree`."""
    if mesh is None:
        return tree
    n = _leading(tree)
    if n == global_size:
        return shard_batch(mesh, tree)
    if n * mesh.world_size == global_size:
        return tree
    raise ValueError(f"a batch of {n} rows is neither the global batch of {global_size} nor "
                     f"one rank's {global_size // mesh.world_size}")


# ------------------------------------------------------------ the active mesh


@dataclasses.dataclass(frozen=True)
class _Active:
    mesh: DataMesh
    outer: int = 1
    inner: int = 1


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("invertavatar_torch_data_mesh",
                                                         default=None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[DataMesh]):
    """Make `mesh` the active data mesh for the body (nothing with None)."""
    if mesh is None:
        yield
        return
    token = _ACTIVE.set(_Active(mesh))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def batch_layout(outer: int = 1, inner: int = 1):
    """Inside `use_mesh`: the per-item tensors of the body have leading axes
    [outer, item, inner] flattened (a clip's [chunk, item, frame] rows), and
    only the item axis is sharded. Nothing without an active mesh."""
    act = _ACTIVE.get()
    if act is None:
        yield
        return
    token = _ACTIVE.set(dataclasses.replace(act, outer=outer, inner=inner))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> Optional[DataMesh]:
    """The mesh of the innermost `use_mesh`, or None."""
    act = _ACTIVE.get()
    return None if act is None else act.mesh


def local_rows(n: int, device=None) -> torch.Tensor:
    """The global row of each of this rank's `n` rows under the active mesh
    and layout: (o, j, t) -> o·(b·N·inner) + (j·N + r)·inner + t; without
    an active mesh, 0..n-1."""
    act = _ACTIVE.get()
    if act is None:
        return torch.arange(n, device=device)
    per = act.outer * act.inner
    if n % per:
        raise ValueError(f"{n} rows are not a [{act.outer}, item, {act.inner}] layout")
    N, b = act.mesh.world_size, n // per
    o = torch.arange(act.outer, device=device)[:, None, None]
    j = torch.arange(b, device=device)[None, :, None]
    t = torch.arange(act.inner, device=device)[None, None, :]
    return (o * (b * N * act.inner) + (j * N + act.mesh.rank) * act.inner + t).reshape(-1)


def batch_rand(shape, generator: Optional[torch.Generator] = None, device=None,
               normal: bool = False) -> torch.Tensor:
    """`torch.rand` (`torch.randn` with `normal`) of a per-item `shape`
    [items, ...]: inside `use_mesh` drawn over the global batch, of which
    this rank's rows are kept."""
    fn = torch.randn if normal else torch.rand
    act = _ACTIVE.get()
    if act is None:
        return fn(shape, generator=generator, device=device)
    shape = tuple(shape)
    full = fn((shape[0] * act.mesh.world_size,) + shape[1:], generator=generator, device=device)
    return full.index_select(0, local_rows(shape[0], full.device))


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks. It is its own adjoint, so its backward is itself,
    which keeps the backward differentiable (R1's double backward)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows `x` [n, ...] as the global [N·n, ...] tensor in the
    global row order, with gradients: each rank writes its rows into a zero
    buffer and one all-reduce sums the buffers; the backward sums the
    cotangent over ranks and keeps this rank's rows. `x` itself without an
    active mesh."""
    act = _ACTIVE.get()
    if act is None:
        return x
    rows = local_rows(x.shape[0], x.device)
    buf = x.new_zeros((x.shape[0] * act.mesh.world_size,) + tuple(x.shape[1:]))
    return _AllReduceSum.apply(buf.index_copy(0, rows, x), act.mesh.group)


def take_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global [N·n, ...] tensor (`x` itself without an
    active mesh)."""
    act = _ACTIVE.get()
    if act is None:
        return x
    return x.index_select(0, local_rows(x.shape[0] // act.mesh.world_size, x.device))


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean over ranks of a per-rank statistic (equal row counts make a
    mean of local means the global mean); `x` without an active mesh."""
    act = _ACTIVE.get()
    if act is None:
        return x
    return _AllReduceSum.apply(x, act.mesh.group) / act.mesh.world_size


def _reduce(x: torch.Tensor, op) -> torch.Tensor:
    act = _ACTIVE.get()
    if act is None:
        return x
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=op, group=act.mesh.group)
    return out


def min_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The elementwise minimum over ranks (no gradient)."""
    return _reduce(x, dist.ReduceOp.MIN)


def max_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over ranks (no gradient)."""
    return _reduce(x, dist.ReduceOp.MAX)


# ------------------------------------------------- parameters and gradients


def _state_tensors(obj) -> List[torch.Tensor]:
    """The tensors `replicate` broadcasts: a module's parameters and buffers,
    an optimizer's per-parameter state (a `MultiSteps`' partial mean too) or
    a `TrainState`'s module and optimizer."""
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if hasattr(obj, "module") and hasattr(obj, "opt"):  # TrainState
        return _state_tensors(obj.module) + _state_tensors(obj.opt)
    if hasattr(obj, "every_k"):  # MultiSteps
        return _state_tensors(obj.opt) + list(obj.acc or [])
    if isinstance(obj, torch.optim.Optimizer):
        out = []
        for group in obj.param_groups:
            for p in group["params"]:
                st = obj.state.get(p, {})
                out += [st[k] for k in sorted(st) if isinstance(st[k], torch.Tensor)]
        return out
    raise TypeError(f"replicate takes modules, optimizers or train states, not "
                    f"{type(obj).__name__}")


@torch.no_grad()
def replicate(mesh: DataMesh, *objs) -> None:
    """Broadcast rank 0's parameters, buffers and optimizer state (modules,
    optimizers, `MultiSteps`, `TrainState`s; None is skipped) to every rank,
    in place."""
    src = _src(mesh)
    for obj in objs:
        if obj is None:
            continue
        for t in _state_tensors(obj):
            dist.broadcast(t, src=src, group=mesh.group)


@torch.no_grad()
def all_reduce_grads(mesh: DataMesh, params: Iterable[torch.Tensor]) -> None:
    """The mean over ranks of each parameter's `.grad`, by one flat
    all-reduce per dtype divided by the world size. A parameter without a
    gradient adds zeros to the buffer, so that every rank flattens the same
    length, and keeps None."""
    by_dtype: dict = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
                          for p in ps])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world_size)
        offset = 0
        for p in ps:
            if p.grad is not None:
                p.grad = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
