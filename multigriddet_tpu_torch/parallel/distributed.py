"""Multi-process data-parallel training: one process per GPU.

Counterpart of ``multigriddet_tpu/parallel/distributed.py``.  The JAX
package runs one process per host over a global device mesh and lets
GSPMD insert the collectives; the port runs one process per GPU under
``torch.distributed`` (NCCL on CUDA tensors, gloo on the CPU) and makes
the same global-batch semantics explicit:

* train-mode BatchNorm averages its batch moments over the ranks
  (``models/layers.py`` ``batch_norm`` through :func:`all_mean`, autograd
  aware), so statistics and gradients are the global batch's;
* the loss divides by global normalizers (``losses/multigrid_loss.py``
  through :func:`world_size` and :func:`all_sum`): each rank's loss is its
  share of the global loss;
* gradients are summed over the ranks once per optimizer update
  (``training/state.py`` ``TrainOptimizer`` through
  :func:`all_reduce_grads`), and the steps sum their metrics
  (:func:`all_sum_metrics`), so every rank reports the global values.

Under a 2-D ``(dp, sp)`` mesh (``parallel/mesh.py``, spatial partitioning
in ``parallel/spatial.py``) the lines and the batch split over ``dp``
(:func:`shard_lines`, :func:`local_batch_size` given the mesh), BatchNorm
all-reduces sums and counts instead of :func:`all_mean`'s per-rank means
(the bands are uneven), and the world sums above stay right: each rank's
loss is its band's share of the global loss.

Config (all optional, ``environment.distributed``)::

    environment:
      distributed:
        enabled: auto            # auto | true | false
        coordinator_address: host:port
        num_processes: 2
        process_id: 0

``enabled: auto`` initializes only when the config or torchrun's variables
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``)
name a group, so a single-process run pays no start-up.  The backend
follows the device: NCCL for CUDA, gloo for the CPU.  Each rank trains on
``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def world_size() -> int:
    """Processes in the data-parallel group (1 when none is initialized)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_multiprocess() -> bool:
    return world_size() > 1


def is_primary() -> bool:
    """True on the process that writes logs, checkpoints and exports."""
    return process_index() == 0


def _env_coordinator() -> Optional[str]:
    addr, port = os.environ.get('MASTER_ADDR'), os.environ.get('MASTER_PORT')
    return f'{addr}:{port}' if addr and port else None


def maybe_initialize(dist_cfg: Optional[Dict[str, Any]],
                     device: Optional[torch.device] = None) -> bool:
    """Initialize the process group from ``dist_cfg`` and torchrun's
    variables when asked; returns whether the run is multi-process.

    Idempotent: with a group already initialized nothing changes.  The
    backend is NCCL for a CUDA ``device`` and gloo otherwise."""
    if dist.is_available() and dist.is_initialized():
        return is_multiprocess()
    cfg = dict(dist_cfg or {})
    enabled = cfg.get('enabled', 'auto')
    if enabled in (False, 'false', 'no'):
        return False
    coord = cfg.get('coordinator_address') or _env_coordinator()
    nproc = cfg.get('num_processes', os.environ.get('WORLD_SIZE'))
    pid = cfg.get('process_id', os.environ.get('RANK'))
    if enabled == 'auto' and coord is None and nproc is None:
        return False            # nothing configured: stay single-process
    if coord is None or nproc is None or pid is None:
        raise ValueError(
            'environment.distributed needs coordinator_address, '
            'num_processes and process_id (or torchrun\'s MASTER_ADDR, '
            f'MASTER_PORT, WORLD_SIZE and RANK); got {coord!r}, {nproc!r}, '
            f'{pid!r}')
    dev = torch.device(device) if device is not None else None
    backend = 'nccl' if dev is not None and dev.type == 'cuda' else 'gloo'
    dist.init_process_group(backend, init_method=f'tcp://{coord}',
                            world_size=int(nproc), rank=int(pid))
    return is_multiprocess()


def local_device(device: torch.device) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK`` (else the rank modulo the
    visible cards) for a CUDA run under a group; ``device`` otherwise."""
    device = torch.device(device)
    if device.type != 'cuda' or world_size() <= 1 or device.index is not None:
        return device
    local = int(os.environ.get('LOCAL_RANK',
                               process_index() % torch.cuda.device_count()))
    torch.cuda.set_device(local)
    return torch.device('cuda', local)


def _batch_axis(mesh) -> Tuple[int, int]:
    """(shards, this process's shard) of the batch: the world's ranks, or
    the mesh's batch axis (a 2-D mesh's space group shares one shard)."""
    if mesh is None:
        return world_size(), process_index()
    return mesh.dp, mesh.batch_index


def shard_lines(lines: Sequence[str], mesh=None) -> List[str]:
    """This process's equal-count shard of the annotation lines, split
    over the ranks or over ``mesh``'s batch axis (the ranks of a space
    group read the same lines).

    Every process must run the same number of steps an epoch or the
    collectives deadlock, so the tail ``len % nproc`` lines are dropped."""
    n, pid = _batch_axis(mesh)
    if n <= 1:
        return list(lines)
    per = len(lines) // n
    return list(lines[pid * per:(pid + 1) * per])


def local_batch_size(global_batch: int, mesh=None) -> int:
    """Per-process batch, so that the shards over the ranks (or over
    ``mesh``'s batch axis) make up the configured global batch."""
    n, _ = _batch_axis(mesh)
    if global_batch % n != 0:
        raise ValueError(f'training.batch_size={global_batch} must divide '
                         f'evenly over {n} processes')
    return global_batch // n


def all_mean(*tensors: torch.Tensor):
    """The tensors averaged over the ranks, with gradients flowing back
    to every rank's inputs (one all-reduce); unchanged single-process."""
    n = world_size()
    if n <= 1:
        return tensors
    from torch.distributed.nn.functional import all_reduce
    return tuple((all_reduce(torch.stack(tensors)) / n).unbind(0))


@torch.no_grad()
def all_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, outside autograd (counts and
    normalizers); ``x`` itself single-process."""
    if world_size() <= 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x


def all_sum_metrics(metrics: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Each scalar metric summed over the ranks in one all-reduce: the
    ranks' shares of the loss terms add up to the global terms."""
    if world_size() <= 1 or not metrics:
        return metrics
    keys = list(metrics)
    total = all_sum(torch.stack([metrics[k].detach().double()
                                 for k in keys]))
    return {k: t.to(metrics[k].dtype) for k, t in zip(keys, total.unbind(0))}


@torch.no_grad()
def all_reduce_grads(params: Sequence[torch.Tensor]):
    """Sum the ``.grad`` of ``params`` over the ranks, in place, in one
    flat all-reduce.  Parameters without a gradient are skipped (the same
    ones on every rank: each runs the same graph)."""
    if world_size() <= 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
