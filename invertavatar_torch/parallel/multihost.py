"""Process groups, replica checks and spawned ranks.

Counterpart of `invertavatar_tpu/parallel/multihost.py`. JAX joins hosts with
`jax.distributed.initialize` and checks replicas by gathering checksums; here
one process drives one card (or a CPU share), joins a `torch.distributed`
process group (`initialize_distributed`: NCCL between cards, gloo on the CPU)
and its collectives carry the gradients. Every collective has a finite
timeout, so a rank that hangs fails the run. `spawn_ranks` starts N ranks of
one function from one process (the GAN CLI's `--gpus`, the dry runs, the
tests): spawned processes rendezvous through a `FileStore`, never a TCP
port. The JAX package's `check_replica_consistency_local` (several devices of
one process) has no counterpart: a process drives one device here.
"""

from __future__ import annotations

import datetime
import os
import uuid
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.misc import resolve_device
from .mesh import DataMesh, _src, make_mesh

DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def initialize_distributed(rank: Optional[int] = None, world_size: Optional[int] = None,
                           local_rank: Optional[int] = None, device=None,
                           backend: Optional[str] = None,
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                           store=None) -> DataMesh:
    """Join the process group and return this rank's data mesh. Arguments
    left out come from torchrun's RANK, WORLD_SIZE and LOCAL_RANK, and the
    rendezvous from MASTER_ADDR / MASTER_PORT unless a `store` is given. The device is card `local_rank` unless another is
    named ("cpu" for the CPU); the backend NCCL on a card, gloo on the CPU.
    `timeout` bounds every collective."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    device = resolve_device("cuda" if device is None else device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if store is None:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world_size, timeout=timeout)
    else:
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=timeout)
    return make_mesh(device)


def global_data_mesh() -> DataMesh:
    """The data mesh over every rank of the default process group."""
    return make_mesh()


def local_batch_slice(global_batch: int, mesh: Optional[DataMesh] = None) -> slice:
    """This rank's rows of a globally indexed batch, as `shard_batch` cuts
    them: every N-th row from the rank's own."""
    mesh = mesh or make_mesh()
    if global_batch % mesh.world_size:
        raise ValueError(f"a batch of {global_batch} does not split over "
                         f"{mesh.world_size} ranks")
    return slice(mesh.rank, global_batch, mesh.world_size)


@torch.no_grad()
def check_replica_consistency(mesh: DataMesh, modules, atol: float = 0.0) -> None:
    """Reference torch_utils/misc.py `check_ddp_consistency`: every parameter
    and buffer of `modules` (a module, or a dict of named modules) agrees
    across ranks, element by element. The tensors of each dtype are
    flattened into one, and group rank 0's copy is broadcast (one broadcast
    the size of `replicate`'s). Each rank compares its copy with rank 0's
    after `torch.nan_to_num`, within `atol`, and also compares where each
    holds NaN, +inf and -inf, which `nan_to_num` maps onto numbers. The
    largest deviation of each tensor is reduced to its maximum over ranks, so
    every rank reaches the same verdict and all raise, naming the first
    tensor that differs. Nothing is exempt: the mapping's `w_avg` is global
    under a mesh."""
    if isinstance(modules, torch.nn.Module):
        modules = {"": modules}
    by_dtype: dict = {}
    for prefix, module in modules.items():
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            by_dtype.setdefault(t.dtype, []).append((f"{prefix}.{name}" if prefix else name,
                                                     t.detach()))
    names = [n for items in by_dtype.values() for n, _ in items]
    if not names:
        return
    devs = []
    for dtype, items in by_dtype.items():
        mine = torch.cat([t.reshape(-1).to(mesh.device) for _, t in items])
        ref = mine.clone()
        dist.broadcast(ref, src=_src(mesh), group=mesh.group)
        if dtype.is_floating_point:
            dev = (torch.nan_to_num(mine) - torch.nan_to_num(ref)).abs()
            dev[_nonfinite_class(mine) != _nonfinite_class(ref)] = float("inf")
        else:
            dev = (mine.to(torch.float64) - ref.to(torch.float64)).abs()
        for d in dev.split([t.numel() for _, t in items]):
            devs.append(d.amax().double() if d.numel() else
                        torch.zeros((), dtype=torch.float64, device=mesh.device))
    dev = torch.stack(devs)
    dist.all_reduce(dev, op=dist.ReduceOp.MAX, group=mesh.group)
    bad = torch.nonzero(dev > atol).flatten()
    if bad.numel():
        i = int(bad[0])
        raise AssertionError(f"rank {mesh.rank}: replicas differ at {names[i]} (largest "
                             f"deviation from group rank 0 over ranks {dev[i].item()!r}, "
                             f"atol {atol!r}; inf where one holds NaN or inf and another "
                             f"does not)")


def _nonfinite_class(t: torch.Tensor) -> torch.Tensor:
    """0 for a finite entry, 1 for NaN, 2 for +inf, 3 for -inf."""
    return (torch.isnan(t).to(torch.int8) + 2 * torch.isposinf(t).to(torch.int8)
            + 3 * torch.isneginf(t).to(torch.int8))


def _rank_main(rank: int, fn: Callable, n_ranks: int, run_dir: str, store_name: str,
               args: Sequence, device: str, backend: Optional[str], timeout_s: float,
               threads: int) -> None:
    torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank)
    store = dist.FileStore(os.path.join(run_dir, store_name), n_ranks)
    mesh = initialize_distributed(rank=rank, world_size=n_ranks, local_rank=dev.index or 0,
                                  device=dev, backend=backend,
                                  timeout=datetime.timedelta(seconds=timeout_s), store=store)
    try:
        result = fn(mesh, *args)
        torch.save(result, os.path.join(run_dir, f"{store_name}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, n_ranks: int, run_dir: str, args: Sequence = (),
                device: str = "cpu", backend: Optional[str] = None, timeout_s: float = 600.0,
                threads: int = 1) -> list:
    """Run `fn(mesh, *args)` on `n_ranks` spawned processes joined through a
    `FileStore` in `run_dir` and return each rank's result (written by the
    rank with `torch.save`). `fn` is a module-level function. `device`
    "cuda" puts rank r on card r (NCCL); "cuda:0" puts every rank on card 0
    (then give `backend` "gloo": NCCL takes one rank per card); "cpu" runs
    gloo on the CPU with `threads` intra-op threads a rank. A rank that
    raises stops the others and raises here; `timeout_s` bounds each
    collective."""
    os.makedirs(run_dir, exist_ok=True)
    store_name = f"store-{uuid.uuid4().hex}"
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, n_ranks, run_dir, store_name, tuple(args), device, backend,
                              timeout_s, threads),
            nprocs=n_ranks, join=True, start_method="spawn")
    finally:
        if os.path.exists(os.path.join(run_dir, store_name)):
            os.remove(os.path.join(run_dir, store_name))
    results = []
    for r in range(n_ranks):
        path = os.path.join(run_dir, f"{store_name}.rank{r}.pt")
        results.append(torch.load(path, weights_only=False))  # written by the rank above
        os.remove(path)
    return results
