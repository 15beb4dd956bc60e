"""Data parallelism over torch.distributed, after the data-parallel part of
paddle_tpu/parallel/mesh.py.

The JAX package runs one SPMD step over a device mesh: feeds are sharded
on the batch axis, parameters replicated, and XLA inserts the collectives.
PyTorch has no single-process SPMD, so the port runs one process per
card (one per `CPU_NUM` slot on the CPU), each a rank of one
torch.distributed world — NCCL between cards, gloo on the CPU — and
makes the step global by hand:

  * every reduction over the batch axis inside a lowering (batch-norm
    statistics, the loss `mean`, `accuracy`) sums its partial results
    over the ranks with `all_reduce_sum`, an autograd function whose
    backward sums the cotangents over the ranks too;
  * after the backward region the gradients of the replicated state are
    averaged over the ranks in flat fp32 buckets
    (fluid/functionalizer.py), before any regularizer or optimizer op.

A `DataParallelGroup` names the world (its size, this rank, the rank's
device and the process group) and counts the collectives it issues.
`launch` starts one process per rank with the `PADDLE_*` environment
that `ops/distributed_ops.py`'s `gen_collective_id` reads.
"""

import collections
import contextlib
import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

__all__ = ["DATA_AXIS", "local_device_count", "rank_card", "init_collective",
           "DataParallelGroup", "data_parallel_group", "all_reduce_sum",
           "row_counts", "gather_rows", "launch", "profiled", "COLLECTIVE_TIMEOUT_S"]

DATA_AXIS = "data"

# how long a collective (and the world's rendezvous) may wait for a
# rank before it fails instead of hanging
COLLECTIVE_TIMEOUT_S = 300


def local_device_count(use_cuda=True):
    """The devices one process trains on: its selected cards
    (fluid/core.py selected_gpus) or else the visible ones, or on the CPU
    `CPU_NUM` (1 when unset), as the reference's parallel_executor.py
    counts places.  use_cuda on a host without CUDA raises."""
    if use_cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("local_device_count(use_cuda=True): CUDA is "
                               "not available on this host")
        from ..fluid import core
        return len(core.selected_gpus()) or torch.cuda.device_count()
    return max(int(os.environ.get("CPU_NUM", "1") or 1), 1)


def rank_card(trainer_id):
    """The card a rank computes on: the first of `FLAGS_selected_gpus`
    when the launcher set it, else trainer_id modulo the visible cards.
    Every card stays visible (NCCL keeps its peer-to-peer routes)."""
    sel = os.environ.get("FLAGS_selected_gpus", "").strip()
    if sel:
        return int(sel.split(",")[0])
    return int(trainer_id) % max(torch.cuda.device_count(), 1)


def init_collective(coordinator, world_size, rank, device_type="cuda"):
    """Join the world of `world_size` ranks whose rank 0 listens at
    `coordinator` ("host:port"): NCCL for a CUDA device, gloo for the
    CPU, with an explicit timeout.  On CUDA the rank's card
    (`rank_card`) is chosen here, once: it becomes the current device and
    what `fluid.CUDAPlace(0)` names in this process.  A second call
    checks that the world it names is the one joined."""
    import torch.distributed as dist
    world_size, rank = int(world_size), int(rank)
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
            raise RuntimeError(
                "init_collective(world %d, rank %d): this process already "
                "joined a world of %d as rank %d"
                % (world_size, rank, dist.get_world_size(), dist.get_rank()))
        return
    if device_type == "cuda":
        from ..fluid import core
        card = rank_card(rank)
        core.select_gpus([card])
        torch.cuda.set_device(card)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="tcp://" + coordinator,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(
                                seconds=COLLECTIVE_TIMEOUT_S))


def profiled(name):
    """A `grp:<name>` torch.profiler range while a profiler records, else
    nothing (fluid_benchmark's trace splits time by these ranges)."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function("grp:" + name)
    return contextlib.nullcontext()


class DataParallelGroup:
    """The data-parallel world as one process sees it: `world_size`,
    `rank`, the rank's `device` and the torch.distributed process group
    (`process_group`; None for a world of one without torch.distributed,
    where every collective is the identity).

    `counts[kind]` and `nbytes[kind]` count the collectives issued and
    the bytes they reduced, by kind ("grad" buckets, "batch_norm",
    "mean", "accuracy", "broadcast", "gather"); `grad_ms` collects the
    wall time of each step's gradient all-reduce while `time_grads` is
    set (it synchronizes the card before and after, so it is off by
    default)."""

    def __init__(self, world_size=1, rank=0, device=None,
                 process_group=None):
        self.world_size = int(world_size)
        self.rank = int(rank)
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        self.process_group = process_group
        self.counts = collections.Counter()
        self.nbytes = collections.Counter()
        self.time_grads = False
        self.grad_ms = []

    def __repr__(self):
        return "DataParallelGroup(world_size=%d, rank=%d, device=%s)" % (
            self.world_size, self.rank, self.device)

    @property
    def active(self):
        """True when collectives leave the process."""
        return self.process_group is not None

    def reset_counts(self):
        self.counts.clear()
        self.nbytes.clear()
        self.grad_ms = []

    def _count(self, kind, t):
        self.counts[kind] += 1
        self.nbytes[kind] += t.numel() * t.element_size()

    def all_reduce_(self, t, kind):
        """Sum `t` over the ranks, in place; returns it.  Under
        torch.profiler the call sits in a `grp:allreduce <kind>` range."""
        self._count(kind, t)
        if self.active:
            import torch.distributed as dist
            with profiled("allreduce " + kind):
                dist.all_reduce(t, group=self.process_group)
        return t

    def broadcast_(self, t, src=0):
        """`t` := rank src's `t`, in place; returns it."""
        self._count("broadcast", t)
        if self.active:
            import torch.distributed as dist
            dist.broadcast(t, src=src, group=self.process_group)
        return t

    def all_gather_rows(self, t):
        """Every rank's `t` concatenated on axis 0 in rank order; the
        ranks' row counts may differ (their other dims may not)."""
        if not self.active:
            return t
        import torch.distributed as dist
        t = t.contiguous()
        rows = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
        sizes = [torch.zeros_like(rows) for _ in range(self.world_size)]
        dist.all_gather(sizes, rows, group=self.process_group)
        sizes = [int(s.item()) for s in sizes]
        pad = max(sizes)
        buf = t.new_zeros((pad,) + tuple(t.shape[1:]))
        buf[:t.shape[0]] = t
        parts = [torch.empty_like(buf) for _ in range(self.world_size)]
        self._count("gather", buf)
        dist.all_gather(parts, buf, group=self.process_group)
        return torch.cat([p[:n] for p, n in zip(parts, sizes)])


def data_parallel_group(use_cuda=True):
    """The group of this process: the torch.distributed world when one is
    initialized (`gen_collective_id`, `init_collective`), else a world of
    one.  Its device is the rank's card (`fluid.CUDAPlace(0)` in the
    rank) or the CPU."""
    import torch.distributed as dist
    from .. import resolve_device
    from ..fluid import core
    place = core.CUDAPlace(0) if use_cuda else core.CPUPlace()
    device = resolve_device(place.torch_device())
    if not dist.is_initialized():
        return DataParallelGroup(1, 0, device, None)
    if dist.get_backend() == "nccl" and device.type != "cuda":
        raise RuntimeError("data_parallel_group(use_cuda=False): the world "
                           "runs NCCL, which reduces CUDA tensors only")
    return DataParallelGroup(dist.get_world_size(), dist.get_rank(), device,
                             dist.group.WORLD)


class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks forward; the cotangents summed over the ranks
    backward (every rank holds the same sum, and each rank's copy of it
    feeds that rank's part of the global step)."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return group.all_reduce_(x.detach().clone(), kind)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_(g.contiguous().clone(),
                                     ctx.kind + "_grad"), None, None


def all_reduce_sum(x, group, kind):
    """x summed over the ranks of `group`, differentiably; `kind` names
    the collective in the group's counts."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group, kind)


def row_counts(x, group):
    """Every rank's row count of `x` (its axis-0 extent), in rank order."""
    return group.all_gather_rows(torch.tensor(
        [x.shape[0]], dtype=torch.int64, device=x.device)).tolist()


def gather_rows(x, group, kind):
    """Every rank's rows of `x` concatenated on axis 0 in rank order,
    differentiably: each rank places its rows in its own block of a
    zero buffer and the buffers are summed with `all_reduce_sum`, so the
    backward sums the cotangents over the ranks as every global
    reduction here does.  The ranks' row counts may differ."""
    if group is None or group.world_size < 2:
        return x
    sizes = row_counts(x, group)
    pad = max(sizes)
    if x.shape[0] < pad:
        x = torch.cat([x, x.new_zeros((pad - x.shape[0],)
                                      + tuple(x.shape[1:]))])
    zero = torch.zeros_like(x)
    placed = torch.cat([x if r == group.rank else zero
                        for r in range(group.world_size)])
    summed = all_reduce_sum(placed, group, kind)
    return torch.cat([summed[r * pad:r * pad + n]
                      for r, n in enumerate(sizes)])


# ---------------------------------------------------------------------------
# one process per rank
# ---------------------------------------------------------------------------

def _free_port():
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.time() + 10
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.time(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(argv, nprocs, use_cuda, env=None, timeout=None, capture=False):
    """Run `python argv...` once per rank, `nprocs` ranks on this host,
    and wait for all.  Each rank gets PADDLE_TRAINER_ID, PADDLE_TRAINERS
    and PADDLE_COORDINATOR (127.0.0.1 and a free port), and on CUDA
    FLAGS_selected_gpus (its card: the rank-th of this process's
    selected cards, else card rank); `env` adds to the parent's
    environment.  When a rank fails the others are ended at once; after
    `timeout` seconds all are ended and TimeoutError raised.

    Returns one (returncode, stdout, stderr) per rank; stdout and stderr
    are None unless `capture`, else the rank's output is the parent's."""
    nprocs = int(nprocs)
    coordinator = "127.0.0.1:%d" % _free_port()
    from ..fluid import core
    cards = core.selected_gpus() or list(range(nprocs))
    procs, files = [], []
    try:
        for rank in range(nprocs):
            e = dict(os.environ)
            e.update(env or {})
            e.update({"PADDLE_TRAINER_ID": str(rank),
                      "PADDLE_TRAINERS": str(nprocs),
                      "PADDLE_COORDINATOR": coordinator})
            if use_cuda:
                e["FLAGS_selected_gpus"] = str(cards[rank])
            out = err = None
            if capture:
                out = tempfile.TemporaryFile("w+")
                err = tempfile.TemporaryFile("w+")
                files.append((out, err))
            procs.append(subprocess.Popen([sys.executable] + list(argv),
                                          env=e, stdout=out,
                                          stderr=err))
        deadline = None if timeout is None else time.time() + timeout
        while True:
            rcs = [p.poll() for p in procs]
            if any(rc not in (None, 0) for rc in rcs):
                break
            if all(rc == 0 for rc in rcs):
                break
            if deadline is not None and time.time() > deadline:
                _stop(procs)
                raise TimeoutError("launch: %d ranks of %r still running "
                                   "after %s s" % (rcs.count(None), argv,
                                                   timeout))
            time.sleep(0.05)
    finally:
        _stop(procs)
    results = []
    for i, p in enumerate(procs):
        out = err = None
        if capture:
            for f in files[i]:
                f.seek(0)
            out, err = files[i][0].read(), files[i][1].read()
            for f in files[i]:
                f.close()
        results.append((p.returncode, out, err))
    return results
