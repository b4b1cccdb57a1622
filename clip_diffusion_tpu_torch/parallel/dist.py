"""One process per GPU over `torch.distributed`.

Counterpart of `clip_diffusion_tpu.parallel.mesh`.  Where the JAX package
shards a batch over a (prompt, seed) device mesh inside one program, the
port runs one process per GPU (launched by `torchrun`, or spawned with
explicit ranks), each on its own rows of the batch: the eager step is
host-bound, so threads in one process would serialize its dispatch.

* `init` joins the process group: NCCL for CUDA devices, gloo for the
  CPU, or the backend named; a backend this build lacks raises.
* `row_range` is `batch_sharding`'s prompt-major contiguous split: rank r
  of N holds rows [r B/N, (r+1) B/N); a batch that does not divide raises.
* `gather_rows` returns the whole batch on every rank.

Without an initialized process group the process is the only rank, and
no collective runs.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from clip_diffusion_tpu_torch.utils.device import resolve_device


def init(device=None, backend: Optional[str] = None, init_method: str = "env://",
         rank: Optional[int] = None, world_size: Optional[int] = None) -> torch.device:
    """Join the default process group and return this rank's device.

    `device` defaults to `cuda`; a CUDA device without an index becomes
    `cuda:LOCAL_RANK` (0 when unset).  `backend` defaults to NCCL on CUDA
    and gloo on the CPU.  `init_method`, `rank` and `world_size` go to
    `torch.distributed.init_process_group` (under `torchrun` the defaults
    read its environment)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_available() or not dist.is_backend_available(backend):
        raise RuntimeError(f"torch.distributed backend {backend!r} is not available in "
                           f"this build of torch {torch.__version__}")
    dist.init_process_group(backend, init_method=init_method,
                            rank=-1 if rank is None else rank,
                            world_size=-1 if world_size is None else world_size)
    return dev


def rank_and_size(group=None) -> Tuple[int, int]:
    """(this process's rank, the number of ranks) in `group`; (0, 1) when
    no process group is initialized."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def row_range(batch: int, group=None) -> Tuple[int, int]:
    """This rank's rows [lo, hi) of a `batch`-row batch."""
    rank, size = rank_and_size(group)
    if batch % size:
        raise ValueError(f"a batch of {batch} rows does not divide over {size} ranks")
    per = batch // size
    return rank * per, (rank + 1) * per


def gather_rows(t: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """Every rank's `t` (equal shapes) concatenated along `dim` in rank
    order, on every rank."""
    if not dist.is_initialized():
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)

