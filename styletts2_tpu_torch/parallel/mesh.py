"""Process-group mesh: data and sequence parallelism over torch.distributed,
one process per GPU.

Counterpart of styletts2_tpu/parallel/mesh.py. JAX's mesh is a set of
devices inside one SPMD program; here every rank is a process that runs
the same entry point with the same arguments (as `torchrun` launches it),
and a `Mesh` is the process group plus this rank's index, the world size
and the rank's device: the parameters are replicated (every rank builds or
loads the same ones, the train loop broadcasts rank 0's), batches are cut
by rows (`shard_batch`), and the frame-sharded vocoder decode
(parallel/seqpar.py) cuts one chunk's time axis.

Every collective is an `all_reduce` or a `broadcast`. A gather is an
all-reduce of a zero-filled buffer into which each rank writes its part
(`assemble`, `gather_rows`): adding zeros is exact, and the messages are
small (durations, phase outputs, the AdaIN statistics, the decoded audio).
No `send`/`recv` and no `all_gather`: NCCL refuses two ranks on one
device, and gloo takes CUDA tensors for `all_reduce` and `broadcast`
only, so the same code runs over NCCL across cards and over gloo with
CUDA tensors as several ranks on one card (and over gloo on the CPU).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

# all_reduce takes these dtypes on every backend; others travel widened
_WIDE = {torch.bfloat16: torch.float32, torch.float16: torch.float32,
         torch.int16: torch.int32, torch.int8: torch.int32,
         torch.uint8: torch.int32, torch.bool: torch.int32}
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Mesh:
    """A 1-D mesh over the ranks of a process group: `group` (None: the
    default group), this process's `rank`, the world `size`, the `device`
    its tensors live on, and the axis name ("dp", or "sp" for a
    sequence-parallel decode)."""

    def __init__(self, group, rank: int, size: int, device,
                 axis: str = "dp"):
        self.group = group
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)
        self.axis_names = (axis,)

    def __repr__(self) -> str:
        return (f"Mesh({self.axis_names[0]}: rank {self.rank} of "
                f"{self.size} on {self.device})")

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place all-reduce of `t` (sum or max); returns `t`."""
        wide = _WIDE.get(t.dtype)
        if wide is None:
            dist.all_reduce(t, op=_OPS[op], group=self.group)
            return t
        w = t.to(wide)
        dist.all_reduce(w, op=_OPS[op], group=self.group)
        return t.copy_(w)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """In-place broadcast of rank `src`'s `t`; returns `t`."""
        dist.broadcast(t, src=src, group=self.group)
        return t

    def all_reduce_mean(self, tensors: Sequence[torch.Tensor]) -> None:
        """Average a list of tensors of one dtype over the ranks in place,
        as one flat all-reduce (one message for a module group's
        gradients)."""
        def mean(flat):
            self.all_reduce(flat)
            flat /= self.size

        _through_flat(tensors, mean)

    def assemble(self, part: torch.Tensor, shape, dim: int,
                 start: int) -> torch.Tensor:
        """The tensor of `shape` whose slice [start, start + part.shape[dim])
        along `dim` is this rank's `part`, the other ranks' slices theirs:
        each rank writes its part into zeros and the buffers are summed
        (the rank's slices must tile `shape` along `dim`)."""
        buf = torch.zeros(shape, dtype=_WIDE.get(part.dtype, part.dtype),
                          device=part.device)
        buf.narrow(dim, start, part.shape[dim]).copy_(part)
        self.all_reduce(buf)
        return buf.to(part.dtype)

    def gather_rows(self, tensors: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
        """Each rank's (b, ...) tensors -> the (size * b, ...) tensors of
        every rank's rows in rank order, on every rank; one all-reduce for
        the list (one dtype)."""
        b = tensors[0].shape[0]
        flat = torch.cat([t.reshape(b, -1) for t in tensors], dim=1)
        full = self.assemble(flat, (self.size * b, flat.shape[1]), 0,
                             self.rank * b)
        out, pos = [], 0
        for t in tensors:
            n = t[0].numel()
            out.append(full[:, pos: pos + n].reshape(
                (self.size * b,) + tuple(t.shape[1:])))
            pos += n
        return out

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of n (n a multiple of the size)."""
        if n % self.size:
            raise ValueError(f"batch {n} is not divisible by the "
                             f"{self.size} ranks of the mesh")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def _through_flat(tensors: Sequence[torch.Tensor], collective) -> None:
    """Run `collective` in place on one flat copy of `tensors` (one dtype)
    and copy the result back into them."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    pos = 0
    for t in tensors:
        t.copy_(flat[pos: pos + t.numel()].view_as(t))
        pos += t.numel()


def pad_to_widest(mesh: Mesh, t: torch.Tensor,
                  fixed: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """This rank's rows `t` (rows, width, ...) zero-padded along dim 1 to
    the widest of the ranks' `t`: the width one collate of the global
    batch gives every row (each rank's loader pads its texts to its own
    longest row, rounded up). `t`'s row count and the shapes of `fixed`
    must already agree on every rank, else every rank raises a
    ValueError. One all-reduce, read on the host."""
    dims = [t.shape[0], t.shape[1]] + [d for f in fixed for d in f.shape]
    v = torch.tensor(dims + [-d for d in dims], dtype=torch.int64,
                     device=mesh.device)
    red = mesh.all_reduce(v, "max").tolist()
    hi, lo = red[:len(dims)], [-d for d in red[len(dims):]]
    if any(h != l for i, (h, l) in enumerate(zip(hi, lo)) if i != 1):
        raise ValueError(f"the ranks' batches differ in shape: sizes "
                         f"{dims} here, from {lo} to {hi} over the ranks")
    extra = hi[1] - t.shape[1]
    if extra == 0:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], extra) +
                                     tuple(t.shape[2:]))], dim=1)


def global_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks as the value, this rank's x times the
    rank count as the gradient: with the gradients then averaged over the
    ranks, a loss written with it differentiates as on the global batch
    (e.g. a ratio of batch sums)."""
    total = mesh.all_reduce(x.detach().clone())
    return mesh.size * x + (total - mesh.size * x).detach()


def global_rows(mesh: Mesh, tensors: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    """Each rank's (b, ...) tensors -> the global batch's (size * b, ...)
    tensors, every other rank's rows as constants and this rank's rows
    live (their gradient flows); one all-reduce. A loss over the global
    rows (a batch median, say) then has the global batch's value; pass it
    through `global_loss` for its gradient."""
    full = mesh.gather_rows([t.detach() for t in tensors])
    out = []
    for t, f in zip(tensors, full):
        b = t.shape[0]
        lo, hi = mesh.rank * b, (mesh.rank + 1) * b
        out.append(torch.cat([f[:lo], t, f[hi:]]))
    return out


def global_loss(mesh: Mesh, loss: torch.Tensor) -> torch.Tensor:
    """A loss over `global_rows`: the same value, the gradient through
    this rank's rows times the rank count (the ranks' gradients are then
    averaged, which sums every rank's share of the global gradient)."""
    return loss + (mesh.size - 1) * (loss - loss.detach())


def init_distributed(device="cuda", backend=None,
                     init_method: str = "env://") -> torch.device:
    """Join the process group from the environment torchrun sets (RANK,
    WORLD_SIZE, LOCAL_RANK; MASTER_ADDR/MASTER_PORT for "env://", or a
    `file://` store given as init_method) and return this rank's device.

    device "cuda" (the default) selects GPU LOCAL_RANK as the current
    device before anything touches CUDA and picks NCCL; it raises on a
    host without a GPU. device "cpu" must be asked for and picks gloo.
    backend overrides the choice (e.g. "gloo" with CUDA tensors: several
    ranks on one GPU). A failed init_process_group raises."""
    missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed: {', '.join(missing)} not set "
                           "(launch with torchrun, or set RANK, WORLD_SIZE "
                           "and LOCAL_RANK)")
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda'): no CUDA "
                               "device is available; pass device='cpu' to "
                               "run on the CPU over gloo")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    elif dev.type != "cpu":
        raise ValueError(f"init_distributed: unsupported device {device!r}")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
    return dev


def make_mesh(n_devices: int = -1, axis: str = "dp",
              device="cuda") -> Mesh:
    """The 1-D mesh over the current process group (init_distributed first).

    n_devices: -1 takes every rank; a positive count must equal the world
    size (the config's `tpu.dp` keeps its name and this meaning: the
    number of data-parallel ranks). device: this rank's tensors; "cuda"
    resolves to the current CUDA device and raises on a host without a
    GPU; "cpu" must be asked for."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.init_distributed() first")
    world = dist.get_world_size()
    if n_devices > 0 and n_devices != world:
        raise ValueError(f"need {n_devices} ranks, the process group has "
                         f"{world}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda'): no CUDA device is "
                               "available; pass device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(None, dist.get_rank(), world, dev, axis)


def shard_batch(mesh: Mesh, batch, local: bool = False):
    """This rank's rows of a batch: a tensor, a numpy array, or a
    dataclass / tuple / list / dict of them (train.Batch, train.Draws),
    with a leading batch axis. Anything else (None, bools, numbers) passes
    through. local=False: `batch` is the global batch and this rank keeps
    its contiguous share of the rows (rank-major); local=True: `batch` is
    already this rank's (the per-rank loader's) and is only moved to the
    mesh's device. Tensors come back on the mesh's device; numpy arrays
    stay numpy."""
    def rec(x):
        if isinstance(x, torch.Tensor):
            return (x if local or x.dim() == 0
                    else x[mesh.rows(x.shape[0])]).to(mesh.device)
        if isinstance(x, np.ndarray):
            return x if local or x.ndim == 0 else x[mesh.rows(x.shape[0])]
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: rec(getattr(x, f.name))
                for f in dataclasses.fields(x)})
        if isinstance(x, (tuple, list)):
            return type(x)(rec(v) for v in x)
        if isinstance(x, dict):
            return {k: rec(v) for k, v in x.items()}
        return x

    return rec(batch)


def broadcast_module(mesh: Mesh, module: torch.nn.Module,
                     src: int = 0) -> None:
    """Make every rank's parameters and buffers rank `src`'s, one broadcast
    per dtype."""
    tensors: dict = {}
    for t in list(module.parameters()) + list(module.buffers()):
        tensors.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in tensors.values():
            _through_flat(ts, lambda flat: mesh.broadcast(flat, src))


def mean_metrics(mesh: Mesh, metrics: dict) -> dict:
    """{name: scalar tensor} -> the mean of each over the ranks, in one
    all-reduce (f32)."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].detach().float().reshape(())
                        for k in keys])
    mesh.all_reduce(vals)
    vals /= mesh.size
    return dict(zip(keys, vals.unbind()))
