"""ParallelExecutor — data-parallel training, after
paddle_tpu/fluid/parallel_executor.py.

The JAX ParallelExecutor is ONE SPMD step over the global batch: feeds
sharded on the batch axis, parameters replicated, XLA's gradient
all-reduce, and every op that mixes rows of the batch axis (batch-norm
statistics, the loss `mean`, `accuracy`, `cumsum` and `slice` along it)
global.  The port computes the
same step with one process per card (parallel/mesh.py): each rank feeds
its local share of the global batch, the lowerings that reduce over the
batch sum over the ranks, and the gradients of the replicated state are
averaged over the ranks at the update region's boundary
(fluid/functionalizer.py).  An op whose lowering is not global and that
mixes rows (a reshape2 that folds the batch axis away, a matmul or mul
contracting over it) raises NotImplementedError at construction.  So with batch norm kept the ranks follow the
single-device Executor's trajectory on the global batch.

    t = fluid.DistributeTranspiler(config)        # config.mode = "collective"
    t.transpile(trainer_id, program=main, trainers=n, startup_program=startup)
    fluid.Executor(fluid.CUDAPlace(0)).run(startup)   # joins the world
    pe = fluid.ParallelExecutor(True, loss.name, main_program=main,
                                num_trainers=n, trainer_id=trainer_id)
    pe.run([loss.name], feed=this_ranks_share)

Fetches follow the JAX package's global arrays: a var with the batch
axis (shape[0] == -1) is gathered from every rank in rank order, a
ragged one as a LoDTensor of every rank's sequences; everything else
(the loss and accuracy, already global; parameters and their grads, the
same on every rank) is the rank's own value.  Each rank seeds the
backward of its replica of the loss, so inside the step the grad of an
activation is the world size times the global step's (the parameters'
grads are averaged over the ranks); a fetched one is scaled back.
Without a torch.distributed world the ParallelExecutor runs a world of
one, the Executor's step, where the host has one device (one card, one
selected card, or CPU_NUM=1); with more it raises rather than train on
one of them (the JAX one takes them all).

`run(..., as_future=True)` dispatches the rank's step without a host
sync and returns a FetchFuture (fluid/pipeline.py), as Executor.run
does; a batch-axis fetch is gathered over the ranks when the future is
resolved (every rank resolves its futures in dispatch order).  A feed
whose tensors already lie on the rank's card (a batch of
`reader.prefetch_to_device(..., group=pe.group)`) is taken as it is,
without a second copy.
"""

import numpy as np
import torch

from ..parallel import mesh
from . import functionalizer
from .core import CPUPlace, CUDAPlace
from .executor import Executor, as_numpy, global_scope
from .framework import GRAD_VAR_SUFFIX, default_main_program, grad_var_name
from .lod import LoDTensor

__all__ = ["ParallelExecutor", "ExecutionStrategy", "BuildStrategy"]

_IR_PASSES_WAIT = ("the IR passes of fluid/ir_passes.py are not ported to "
                   "paddle_tpu_torch yet (ROADMAP.md, queue 1 item 11)")


class ExecutionStrategy:
    """reference details/execution_strategy.h.  Accepted for API parity
    and advisory: the port's step runs its ops in program order on one
    stream per rank."""

    def __init__(self):
        self.num_threads = 0
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 100
        self.use_experimental_executor = False


class BuildStrategy:
    """reference details/build_strategy.h:95.  reduce_strategy,
    enable_data_balance and memory_optimize are advisory (the gradients
    are all-reduced); fuse_elewise_add_act_ops and debug_graphviz_path
    need IR passes that are not ported and raise."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.debug_graphviz_path = ""
        self.enable_data_balance = False
        self.memory_optimize = False
        self.fuse_elewise_add_act_ops = False


def _local_feed(feed):
    """This rank's feed: a dict, or a list of per-device dicts merged."""
    if isinstance(feed, (list, tuple)):
        return _merge_device_feeds(feed)
    return feed


def _merge_device_feeds(feeds):
    """A list of per-device feed dicts as one dict: arrays concatenated on
    the batch axis (tensors on their device), LoDTensors with their
    sequence lengths concatenated per level (the JAX ParallelExecutor's
    merge)."""
    merged = {}
    for k in feeds[0]:
        vals = [d[k] for d in feeds]
        ragged = [isinstance(v, LoDTensor) and bool(v.lod()) for v in vals]
        if not any(ragged):
            if all(isinstance(v, torch.Tensor) for v in vals):
                merged[k] = torch.cat(vals, dim=0)
            else:
                merged[k] = np.concatenate(
                    [as_numpy(v) if isinstance(v, torch.Tensor)
                     else np.asarray(v) for v in vals], axis=0)
            continue
        if not all(ragged):
            raise ValueError("feed '%s': mixed LoDTensor and dense entries "
                             "across devices" % k)
        depth = len(vals[0].lod())
        if any(len(v.lod()) != depth for v in vals):
            raise ValueError("feed '%s': inconsistent LoD depth across "
                             "devices" % k)
        t = LoDTensor(np.concatenate([v.numpy() for v in vals], axis=0))
        t.set_recursive_sequence_lengths(
            [sum((v.recursive_sequence_lengths()[lv] for v in vals), [])
             for lv in range(depth)])
        merged[k] = t
    return merged


class _RankExecutor(Executor):
    """The Executor of one rank: its step reduces over `group`, and its
    fetches follow the JAX package's global arrays (module docstring)."""

    def __init__(self, place, group, program):
        super().__init__(place)
        self._group = group
        self._program = program

    def _var(self, name):
        return self._program.global_block()._find_var_recursive(name)

    def _has_batch_axis(self, name):
        v = self._var(name)
        return (v is not None and not v.persistable and v.shape is not None
                and len(v.shape) > 0 and (v.shape[0] is None
                                          or v.shape[0] < 0))

    def _is_activation_grad(self, name):
        """The grad of a var that is not replicated state."""
        if GRAD_VAR_SUFFIX not in name:
            return False
        v = self._var(name[:name.index(GRAD_VAR_SUFFIX)])
        return v is not None and not v.persistable

    def _fetch_out(self, name, val, lens, seg, return_numpy):
        g = self._group
        if g.world_size == 1:
            return super()._fetch_out(name, val, lens, seg, return_numpy)
        # a nested var never reaches a world of several ranks
        # (_check_nested raises when the executor is built)
        if self._is_activation_grad(name):
            val = val / g.world_size
        if lens is not None:
            return self._gather_lod(
                super()._fetch_out(name, val, lens, None, return_numpy))
        if self._has_batch_axis(name):
            # a resolved future hands the host copy: gather on the card
            val = g.all_gather_rows(val.to(g.device))
        return super()._fetch_out(name, val, None, None, return_numpy)

    def _gather_lod(self, t):
        """Every rank's sequences of a ragged fetch, in rank order."""
        dev = self._group.device
        rows = self._group.all_gather_rows(
            torch.from_numpy(np.ascontiguousarray(t.numpy())).to(dev))
        lens = self._group.all_gather_rows(torch.tensor(
            t.recursive_sequence_lengths()[-1], dtype=torch.int64,
            device=dev))
        g = LoDTensor(as_numpy(rows))
        g.set_recursive_sequence_lengths([lens.tolist()])
        return g


def _batch_var(block, name):
    """The var when it is a batch-axis activation (shape[0] == -1)."""
    v = block._find_var_recursive(name)
    if v is None or v.persistable or not v.shape or \
            not (v.shape[0] is None or v.shape[0] < 0):
        return None
    return v


def _known_prod(dims):
    """The product of `dims`, or None when one is unknown (-1)."""
    n = 1
    for d in dims:
        if d is None or d < 0:
            return None
        n *= int(d)
    return n


def _row_mixing(op, block):
    """The batch-axis var `op` mixes rows of, or None.  A reshape2 whose
    target does not keep the batch axis leading, or that merges rows
    into one; a matmul or mul that contracts over the batch axis; a
    lod_reset that regroups the rows of the batch's sequences (by Y or
    by target_lod); a sequence_mask whose width is max(X) over the batch
    (maxlen -1).  The other sequence and recurrent ops compute each
    sequence on its own row.  cumsum, slice, mean, batch_norm and
    accuracy are global lowerings and never come here."""
    if op.type == "lod_reset":
        v = _batch_var(block, op.input("X")[0])
        if v is not None and (op.input("Y")
                              or op.attrs.get("target_lod")):
            return v.name
        return None
    if op.type == "sequence_mask":
        v = _batch_var(block, op.input("X")[0])
        maxlen = op.attrs.get("maxlen", -1)
        if v is not None and (maxlen is None or maxlen < 0):
            return v.name
        return None
    if op.type == "reshape2":
        v = _batch_var(block, op.input("X")[0])
        if v is None:
            return None
        shape = [int(d) for d in op.attrs.get("shape", [])]
        if not shape or shape[0] not in (-1, 0):
            return v.name
        if shape[0] == -1:
            have = _known_prod(v.shape[1:])
            want = _known_prod(shape[1:])
            if have is not None and want is not None and want > have:
                return v.name
        return None
    if op.type == "matmul":
        x = _batch_var(block, op.input("X")[0])
        y = _batch_var(block, op.input("Y")[0])
        if x is not None and len(x.shape) == 2 and \
                op.attrs.get("transpose_X", False):
            return x.name
        if y is not None and len(y.shape) == 2 and \
                not op.attrs.get("transpose_Y", False):
            return y.name
        return None
    if op.type == "mul":
        x = _batch_var(block, op.input("X")[0])
        y = _batch_var(block, op.input("Y")[0])
        if x is not None and int(op.attrs.get("x_num_col_dims", 1)) < 1:
            return x.name
        if y is not None:
            return y.name
    return None


def _check_row_mixing(program):
    """Raise for an op the port cannot make global under the data-parallel
    world: it would compute over the rank's share of the batch where the
    JAX ParallelExecutor computes over the global batch."""
    for block in program.blocks:
        for op in block.ops:
            name = _row_mixing(op, block)
            if name is not None:
                raise NotImplementedError(
                    "ParallelExecutor: op %r mixes rows of the batch axis "
                    "of var %r, and its lowering is not global under the "
                    "data-parallel world (only batch_norm, mean, accuracy, "
                    "cumsum and slice are); each rank would compute over "
                    "its share of the batch.  Keep the batch axis leading, "
                    "or run the program on one Executor" % (op.type, name))


# the ops that read a nested var's outer groups (the @LOD_SEG counts):
# their results depend on which outer groups, and which of a group's
# inner sequences, a rank holds
_NESTED_OPS = frozenset(["nested_to_outer", "nested_to_outer_grad",
                         "sub_nested_seq"])


def _check_nested(program):
    """Raise for a nested (lod_level-2) feed or a nested op in a world of
    several ranks.  The JAX ParallelExecutor shards the @LOD_LEN and
    @LOD_SEG companions with their payload along the batch axis, which
    for a nested var is the axis of INNER sequences: an outer group can
    straddle two ranks, and a rank's counts then no longer sum to its
    rows.  The port does not split the batch that way, so it raises."""
    for block in program.blocks:
        for v in block.vars.values():
            if v.is_data and (v.lod_level or 0) >= 2:
                raise NotImplementedError(
                    "ParallelExecutor: feed %r is nested (lod_level %d): "
                    "its outer groups would be split across the ranks "
                    "with their inner sequences, and the per-group "
                    "counts (@LOD_SEG) would not hold on any rank; run "
                    "nested programs on one Executor"
                    % (v.name, v.lod_level))
        for op in block.ops:
            # sequence_expand reads Y's outer counts, kmax_seq_score X's
            slot = {"sequence_expand": "Y", "kmax_seq_score": "X"}.get(
                op.type)
            levels = [(getattr(block._find_var_recursive(n), "lod_level",
                               0) or 0) for n in op.input(slot)] \
                if slot else []
            if op.type in _NESTED_OPS or any(lv >= 2 for lv in levels):
                raise NotImplementedError(
                    "ParallelExecutor: op %r reads the outer groups of a "
                    "nested var, which the ranks' shares of the batch "
                    "split; run nested programs on one Executor" % op.type)


class ParallelExecutor:
    """reference parallel_executor.py:32.  `use_cuda` runs on the rank's
    card (CUDAPlace(0) in the rank), else on the CPU; a host without
    CUDA raises for use_cuda, and so does one process with more than one
    local device (mesh.local_device_count) outside a world.  With
    num_trainers > 1 the torch.distributed world (joined by the startup
    program's gen_collective_id) must have num_trainers ranks and this
    process must be rank trainer_id.  The
    state in the scope is broadcast from rank 0 here (the reference's
    BCastParamsToDevices)."""

    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        self._main_program = main_program if main_program is not None \
            else default_main_program()
        self._scope = scope if scope is not None else global_scope()
        if share_vars_from is not None:
            self._scope = share_vars_from._scope
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._build_strategy = build_strategy or BuildStrategy()
        self._loss_name = loss_name
        self._num_trainers = int(num_trainers or 1)
        self._trainer_id = int(trainer_id or 0)
        if self._build_strategy.fuse_elewise_add_act_ops:
            raise NotImplementedError(
                "BuildStrategy.fuse_elewise_add_act_ops: " + _IR_PASSES_WAIT)
        if self._build_strategy.debug_graphviz_path:
            raise NotImplementedError(
                "BuildStrategy.debug_graphviz_path: " + _IR_PASSES_WAIT)
        self._group = mesh.data_parallel_group(use_cuda)
        self._exe = _RankExecutor(CUDAPlace(0) if use_cuda else CPUPlace(),
                                  self._group, self._main_program)
        if self._num_trainers > 1:
            if self._group.world_size != self._num_trainers:
                raise RuntimeError(
                    "ParallelExecutor(num_trainers=%d) but the collective "
                    "world has %d processes: run gen_collective_id (the "
                    "collective-mode transpiler prepends it to the startup "
                    "program) with PADDLE_COORDINATOR set, or "
                    "parallel.mesh.init_collective, first"
                    % (self._num_trainers, self._group.world_size))
            if self._group.rank != self._trainer_id:
                raise RuntimeError(
                    "trainer_id=%d does not match collective rank %d"
                    % (self._trainer_id, self._group.rank))
        elif not self._group.active:
            n = mesh.local_device_count(use_cuda)
            if n > 1:
                raise RuntimeError(
                    "ParallelExecutor: this host has %d %s and no "
                    "torch.distributed world was joined; one process "
                    "trains on one device.  Start one trainer per device "
                    "(parallel.mesh.launch, or `python -m "
                    "paddle_tpu_torch.fluid_benchmark --parallel`) that "
                    "runs the collective-mode transpiler's startup "
                    "program, or select one device (%s) to train a world "
                    "of one" % (n, "cards" if use_cuda else "CPU_NUM slots",
                                "FLAGS_selected_gpus=<card>" if use_cuda
                                else "CPU_NUM=1"))
        if self._group.world_size > 1:
            _check_nested(self._main_program)
            _check_row_mixing(self._main_program)
        self._apply_gradient_scale_strategy()
        self._broadcast_state()

    def _apply_gradient_scale_strategy(self):
        """reference details/build_strategy.h:55 and the JAX package's
        encoding.  The ranks average their gradients, so with
        CoeffNumDevice (the default) the step's gradient is the global
        batch's; One seeds the loss grad with the world size (the
        gradient is world-size times larger, as when each device seeds
        1.0 and the grads are summed), by rewriting the backward's
        fill_constant seed; Customized has no per-device seed to feed
        here and raises."""
        strat = self._build_strategy.gradient_scale_strategy
        if strat == BuildStrategy.GradientScaleStrategy.CoeffNumDevice:
            return
        if strat == BuildStrategy.GradientScaleStrategy.Customized:
            raise NotImplementedError(
                "GradientScaleStrategy.Customized: supply a custom loss "
                "scale by scaling the loss itself (the step is one global "
                "computation; there is no per-device seed to feed)")
        if self._loss_name is None:
            return
        target = grad_var_name(self._loss_name)
        for op in self._main_program.global_block().ops:
            if op.type == "fill_constant" and \
                    op.outputs.get("Out", [None])[0] == target:
                if not op.attrs.get("@grad_scale_applied"):
                    op.attrs["value"] = float(op.attrs.get("value", 1.0)) \
                        * self.device_count
                    op.attrs["@grad_scale_applied"] = True
                    self._main_program._bump_version()
                break

    def _broadcast_state(self):
        """Every persistable in the scope := rank 0's, on this rank's
        device, in the program's order (the same on every rank)."""
        dev = self._group.device
        for name in functionalizer.persistable_names(self._main_program):
            val = self._scope.get(name)
            if val is None:
                continue
            val = val.to(dev).contiguous()
            if self._group.active:
                val = self._group.broadcast_(val.clone())
            self._scope.set(name, val)

    @property
    def device_count(self):
        """The world size: one card (or CPU slot) per rank."""
        return self._group.world_size

    @property
    def group(self):
        """The parallel.mesh.DataParallelGroup this executor reduces over
        (its counts of collectives and bytes)."""
        return self._group

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True,
            as_future=False):
        """reference parallel_executor.py:169: one step of the global
        batch.  `feed` (or `feed_dict`) is this rank's share of it: one
        dict, or a list of per-device dicts that are concatenated.  With
        `as_future=True` the step is dispatched without a host sync and
        a FetchFuture comes back (module docstring)."""
        return self._exe.run(self._main_program, feed=_local_feed(
            feed if feed is not None else feed_dict),
            fetch_list=fetch_list, scope=self._scope,
            return_numpy=return_numpy, as_future=as_future)

    def run_loop(self, fetch_list, feed=None, steps=1, return_numpy=True):
        """`steps` global steps on one feed, as `steps` run() calls (each
        with its gradient all-reduce); returns the last step's fetches.
        The step counter advances only when every step succeeded."""
        return self._exe.run_loop(self._main_program, feed=_local_feed(feed),
                                  fetch_list=fetch_list, steps=steps,
                                  scope=self._scope,
                                  return_numpy=return_numpy)
