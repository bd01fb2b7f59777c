"""Data parallelism across processes (port of `spinnerf_tpu/parallel/mesh.py`).

The JAX package runs one controller, and GSPMD shards the ray batch inside
the jitted step. PyTorch has no single-controller SPMD, so the port runs one
process per rank and makes every collective explicit:

- training: every rank draws the whole batch from the same seeded generator
  and keeps its rows; the gradients are averaged across ranks in one flat
  all-reduce a step, so every rank applies the same optimizer update, and
  the parameters are broadcast from rank 0 at the start and on a resume;
- rendering: each chunk of a frame's pixels is split across the ranks and
  the result gathered (`gather_rows`);
- BatchNorm in train mode takes its statistics over the whole batch
  (`all_reduce_sum`, differentiable).

A `Mesh` is this process's place in the group: its rank, the world size and
the device its tensors live on. Without a process group there is no mesh
(`current()` is None) and nothing changes: no collective runs.

`launch(n, fn, *args, device=None)` spawns n ranks that rendezvous through a
file in a temporary directory. With `device=None` rank r takes `cuda:r` over
NCCL; with a device every rank takes that device over gloo (the CPU, or all
ranks on one card, which NCCL refuses). `torchrun` sets up the same group
through `join()`.
"""
from __future__ import annotations

import collections
import datetime
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path
from typing import NamedTuple

import torch
import torch.distributed as dist

# long enough for rank 0 to run a stage alone (the LaMa guidance, the eval)
# while the others wait at a barrier; a rank that dies ends a `launch` at
# once, since the launcher stops the others when one exits with an error
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)

# collective calls made by this process, by kind (a wrapper counts where it
# calls torch.distributed, and nowhere else)
calls: collections.Counter = collections.Counter()


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class Mesh(NamedTuple):
    """One rank of a data-parallel process group."""
    rank: int
    size: int
    device: torch.device

    def shard_rows(self, x):
        """This rank's contiguous 1/size of x's leading dimension; raises
        ValueError when the size does not divide it."""
        n = x.shape[0]
        if n % self.size:
            raise ValueError(f"a leading dimension of {n} does not split "
                             f"over {self.size} ranks")
        k = n // self.size
        return x[self.rank * k:(self.rank + 1) * k]

    def all_reduce_mean_(self, tensors):
        """Average `tensors` across the ranks, in place, as one flat buffer
        per dtype and device (one collective for all of a step's
        gradients)."""
        for group in _by_dtype(tensors):
            flat = torch.cat([t.reshape(-1) for t in group])
            _all_reduce(flat)
            flat.div_(self.size)
            for t, part in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(part.view_as(t))

    def mean_metrics(self, metrics: dict) -> dict:
        """The mean across ranks of each 0-d metric, detached, in one
        collective."""
        names = list(metrics)
        flat = torch.stack([metrics[n].detach().float() for n in names])
        _all_reduce(flat)
        flat = flat / self.size
        return dict(zip(names, flat.unbind()))

    def any(self, flag):
        """True (a 0-d bool tensor) on every rank when `flag` is on any."""
        f = flag.detach().to(torch.float32).reshape(1).clone()
        _all_reduce(f)
        return f[0] > 0

    def sum(self, x):
        """The sum across ranks of x, without a gradient."""
        x = x.detach().clone()
        _all_reduce(x)
        return x

    def gather_rows(self, tensors):
        """Each rank's rows of `tensors` (equal counts on every rank),
        concatenated in rank order, on every rank. Gloo has no all-gather
        of CUDA tensors, so this all-reduces a zero-padded buffer: each
        rank writes its block, the sum leaves every block as its rank wrote
        it, bit for bit."""
        out = [None] * len(tensors)
        for group, where in _by_dtype(tensors, positions=True):
            rows = group[0].shape[0]
            widths = [t[0].numel() for t in group]
            flat = torch.cat([t.reshape(rows, -1) for t in group], dim=1)
            buf = flat.new_zeros((self.size,) + tuple(flat.shape))
            buf[self.rank] = flat
            _all_reduce(buf)
            buf = buf.reshape(self.size * rows, -1)
            for i, part in zip(where, buf.split(widths, dim=1)):
                out[i] = part.reshape((self.size * rows,)
                                      + tuple(tensors[i].shape[1:]))
        return out

    def broadcast_(self, tensors, src: int = 0):
        """Overwrite `tensors` with rank `src`'s values, one flat buffer per
        dtype and device."""
        for group in _by_dtype(tensors):
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            calls["broadcast"] += 1
            dist.broadcast(flat, src)
            with torch.no_grad():
                for t, part in zip(group,
                                   flat.split([t.numel() for t in group])):
                    t.copy_(part.view_as(t))

    def broadcast_object(self, obj, src: int = 0):
        """Rank `src`'s `obj` (picklable), on every rank."""
        box = [obj]
        calls["broadcast"] += 1
        dist.broadcast_object_list(box, src,
                                   device=self.device
                                   if self.device.type == "cuda" else None)
        return box[0]

    def replicas_equal(self, tensors) -> bool:
        """Whether `tensors` hold the same bits on every rank: a position-
        weighted sum of their bit patterns, its largest and smallest value
        across ranks compared (the same answer on every rank)."""
        c = torch.zeros((), dtype=torch.int64, device=self.device)
        for t in tensors:
            bits = t.detach().reshape(-1).view(_INT_OF_SIZE[t.element_size()])
            w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
            c = c + (bits.to(torch.int64) * w).sum().to(self.device)
        both = torch.stack([c, -c])
        _all_reduce(both, dist.ReduceOp.MAX)
        return bool(both[0] == -both[1])

    def barrier(self):
        """Wait for every rank (an all-reduce on the mesh's device, which
        every backend supports)."""
        _all_reduce(torch.zeros(1, device=self.device))


def _by_dtype(tensors, positions=False):
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    for idx in groups.values():
        group = [tensors[i] for i in idx]
        yield (group, idx) if positions else group


_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


def _all_reduce(x, op=dist.ReduceOp.SUM):
    calls["all_reduce"] += 1
    dist.all_reduce(x, op=op)


class _AllReduceSum(torch.autograd.Function):
    """Sum across ranks whose gradient is the sum of the ranks' gradients:
    rank r's input reaches every rank's output with weight 1."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        _all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        _all_reduce(g)
        return g


def all_reduce_sum(x):
    """Differentiable sum of x across the ranks of the process group."""
    return _AllReduceSum.apply(x)


def quiet(*args, **kwargs):
    """The log of a rank that does not write."""


def rank0_only(mesh: Mesh | None, fn, *args, **kwargs):
    """fn(*args, **kwargs) on rank 0 alone while the other ranks wait;
    every rank returns rank 0's result (picklable). Without a mesh, just
    the call."""
    if mesh is None:
        return fn(*args, **kwargs)
    out = fn(*args, **kwargs) if mesh.rank == 0 else None
    return mesh.broadcast_object(out)


# the mesh `join` made in this process (None before, and after `leave`)
_joined: Mesh | None = None


def current() -> Mesh | None:
    """This process's mesh: the process group it joined, or None."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if _joined is not None:
        return _joined
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(dist.get_rank(), dist.get_world_size(), device)


def for_config(mesh_shape: int) -> Mesh | None:
    """The mesh a run with `--mesh_shape` trains on: the process group this
    process joined (None without one). 0 takes any group; N > 0 requires a
    group of N ranks (none for N = 1) and raises ValueError otherwise."""
    mesh = current()
    size = 1 if mesh is None else mesh.size
    if mesh_shape > 0 and mesh_shape != size:
        raise ValueError(
            f"--mesh_shape {mesh_shape} trains on {mesh_shape} ranks, one "
            f"process each, and this process is in a group of {size}: run "
            f"`python -m spinnerf_tpu_torch.cli <command> --mesh_shape "
            f"{mesh_shape} ...` (it launches the ranks), `torchrun "
            f"--nproc_per_node {mesh_shape} -m spinnerf_tpu_torch.cli ...`, "
            f"or call `spinnerf_tpu_torch.parallel.launch({mesh_shape}, fn, "
            f"...)`")
    return mesh


def join(rank: int | None = None, size: int | None = None, *, device=None,
         init_method: str = "env://",
         timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """Join a process group of `size` ranks as `rank` (both from torchrun's
    RANK / WORLD_SIZE when None) and return this process's mesh. Without a
    device the rank takes its own card (`cuda:LOCAL_RANK`, else
    `cuda:rank`) over NCCL; with one, that device over gloo."""
    global _joined
    rank = int(os.environ["RANK"]) if rank is None else rank
    size = int(os.environ["WORLD_SIZE"]) if size is None else size
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=size, rank=rank, timeout=timeout)
    _joined = Mesh(rank, size, device)
    return _joined


def leave():
    """Leave the process group `join` made."""
    global _joined
    if dist.is_initialized():
        dist.destroy_process_group()
    _joined = None


def _rank_main(rank, n, payload, device, init_method, out_dir):
    """One launched rank: join, run fn(*args, device=...) from the pickled
    (fn, args), save the result or the error for the launcher."""
    torch.set_num_threads(1)
    out = Path(out_dir)
    try:
        fn, args = pickle.loads(payload)
        mesh = join(rank, n, device=device, init_method=init_method)
        result = fn(*args, device=mesh.device)
        leave()
        torch.save(result, out / f"result_{rank}.pt")
    except BaseException as e:          # reported to the launcher, re-raised
        when = time.time()
        text = traceback.format_exc()
        try:
            blob = pickle.dumps(e)
        except Exception:               # an exception that does not pickle
            blob = None
        (out / f"error_{rank}.pkl").write_bytes(
            pickle.dumps((when, text, blob)))
        # no `leave()`: the other ranks may sit in a collective; the
        # launcher stops them
        os._exit(1)


def launch(n: int, fn, *args, device=None):
    """Run `fn(*args, device=<the rank's device>)` on n ranks, one spawned
    process each, in a process group (see the module docstring for the
    device and the backend). Returns each rank's result, in rank order.

    `fn` must be importable by name (a module-level function) and its
    arguments and result picklable. When a rank fails, the others are
    stopped and the first exception (the others' follow from it) is
    re-raised here."""
    if device is None and torch.cuda.device_count() < n:
        raise ValueError(
            f"launch({n}) puts one rank on each CUDA card and this machine "
            f"has {torch.cuda.device_count()}; pass device= to put every "
            f"rank on one device (over gloo)")
    ctx = multiprocessing.get_context("spawn")
    # pickled here, by value: multiprocessing's own pickler would hand every
    # rank the same shared-memory tensors, which a rank then updates in
    # place under the others
    payload = pickle.dumps((fn, args))
    with tempfile.TemporaryDirectory(prefix="spinnerf_dp_") as tmp:
        init_method = f"file://{Path(tmp) / 'rendezvous'}"
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, payload,
                                   None if device is None else str(device),
                                   init_method, tmp),
                             name=f"rank{r}")
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        errors = [pickle.loads(path.read_bytes()) + (r,) for r in failed
                  if (path := Path(tmp) / f"error_{r}.pkl").exists()]
        if errors:
            _, text, blob, r = min(errors, key=lambda e: e[0])
            err = RuntimeError(f"rank {r} of {n} failed:\n{text}")
            if blob is None:
                raise err
            raise pickle.loads(blob) from err
        if failed:
            raise RuntimeError(
                f"ranks {failed} of {n} exited with codes "
                f"{[procs[r].exitcode for r in failed]}")
        return [torch.load(Path(tmp) / f"result_{r}.pt", map_location="cpu",
                           weights_only=False) for r in range(n)]
