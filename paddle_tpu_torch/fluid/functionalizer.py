"""Block functionalization, after paddle_tpu/fluid/functionalizer.py: a
Program becomes a pure step function `fn(state, feeds, step) ->
(fetches, new_state)` over dicts of torch tensors, which the Executor
calls once per step.

The JAX package traces the step into one jitted computation.  The port
interprets it eagerly, in one of two forms:

  * per op (`run_block`): every op in program order; a forward op whose
    `<type>_grad` comes later runs under autograd and stashes its vjp
    closure (ops/registry.py make_forward_and_vjp), which the grad op
    consumes;
  * whole graph (`build_whole_graph_step_fn`, FLAGS.whole_graph_ad): the
    backward region is dropped, the forward region runs once under
    autograd with the differentiated vars as leaves, and ONE
    `torch.autograd.grad` stands in for the JAX package's `jax.vjp`.
    Only this form can rematerialize (`_resolve_remat_policy`): the
    forward region is the differentiated function, so
    `torch.utils.checkpoint` can drop activations and recompute them in
    the backward.

`run_loop` is the JAX package's `jit_loop` as a plain loop of the step.

Control flow: an op with a `sub_block` attr (ops/control_flow_ops.py:
while, conditional_block, recurrent) runs its block through
`run_sub_block`, the same interpreter over an env of its own, in the
caller's grad mode, so autograd records a loop's trips when the op runs
under make_forward_and_vjp and its generic `<type>_grad` replays them.
The env ops (`_ENV_OPS`) read and write the interpreter's env by name.
The drop plan counts what an op's sub-blocks read and write as the op's
own (`_op_tree_reads`, `_op_tree_writes`).  The whole-graph step declines
a program whose forward or update region holds a sub-block op, as the
JAX package's does, and the per-op step runs it.

Data parallelism (fluid/parallel_executor.py): a step built with a
`group` (parallel/mesh.py DataParallelGroup) is one rank's part of the
global step.  Every lowering sees the group (ExecContext.group) and makes
its batch reductions global; and at the boundary of the update region
(`_backward_region`: after the backward, before any regularizer or
optimizer op) the gradients of the replicated state are averaged over
the ranks in flat fp32 buckets (`all_reduce_grads`), on both forms.  The
whole-graph form seeds its backward with the seed op's value, as the
per-op form does, so a loss-grad scale set there (GradientScaleStrategy.
One) holds on both.

Ragged (LoD) vars are padded [B, T, ...] tensors in the env, each with a
`<name>@LOD_LEN` int32 [B] lengths companion (fluid/lod.py).  An op sees
the companions of its inputs as `<slot>@LOD_LEN` input slots
(ExecContext.lod_len); a lowering may write `<slot>@LOD_LEN` outputs,
and every other op's outputs inherit its first ragged input's lengths
(`_propagate_lod`), except the ops of `_LOD_DROP_OPS`, which reduce over
time.  A nested (lod_level-2) var also carries `<name>@LOD_SEG`, the
int32 [B_outer] counts of its inner sequences per outer group
(ExecContext.lod_seg), which rides beside `@LOD_LEN` everywhere.  A
companion lives as long as its var, and is an integer input that
autograd never differentiates.
"""

import functools
import time

import torch
from torch.utils import checkpoint as torch_checkpoint

from ..ops import registry
from ..parallel import mesh
from .framework import GRAD_VAR_SUFFIX as GRAD_SUFFIX, grad_var_name
from .selected_rows import SelectedRowsValue

__all__ = ["persistable_names", "run_block", "run_sub_block",
           "build_step_fn",
           "build_whole_graph_step_fn", "run_loop", "flags_ad_config",
           "all_reduce_grads", "LOD_LEN_SUFFIX", "LOD_SEG_SUFFIX",
           "GRAD_BUCKET_BYTES"]

# the companion of a ragged var: its int32 [B] sequence lengths
LOD_LEN_SUFFIX = "@LOD_LEN"
# the second companion of a nested (lod_level-2) var: the int32 [B_outer]
# COUNT of inner sequences in each outer group (counts, not ids, so a
# trailing empty outer group survives).  Inner-level ops ignore it; the
# outer-level ops (sub_nested_seq, nested kmax_seq_score,
# nested_to_outer, sequence_expand with a nested Y) read it.
LOD_SEG_SUFFIX = "@LOD_SEG"
_COMPANIONS = (LOD_LEN_SUFFIX, LOD_SEG_SUFFIX)

# ops whose outputs leave the ragged domain (they reduce over time, or
# are not row views of their inputs): their outputs inherit no lengths.
# The JAX package's set, kept whole so both packages agree as ops land.
_LOD_DROP_OPS = frozenset([
    "sequence_pool", "sequence_first_step", "sequence_last_step",
    "sequence_length", "kmax_seq_score", "lambda_rank",
    "sequence_mask", "mean", "reduce_sum", "reduce_mean", "reduce_max",
    "shape", "accuracy", "top_k",
    "linear_chain_crf", "warpctc", "edit_distance", "chunk_eval", "auc",
    "mean_iou", "precision_recall",
    "bipartite_match", "target_assign", "mine_hard_examples",
    "multiclass_nms", "generate_proposals",
    "sequence_scatter",
    "detection_map", "generate_proposal_labels", "lod_rank_table",
    "while_grad_dynamic",
])


# ops that read and write the interpreter env by name (control flow and
# tensor arrays); the rest see only their inputs
_ENV_OPS = frozenset(["conditional_block", "write_to_array"])


def persistable_names(program):
    return [v.name for blk in program.blocks for v in blk.vars.values()
            if v.persistable]


def flags_ad_config():
    """(whole_graph_ad, remat_policy) from FLAGS: a remat policy implies
    whole-graph AD, so a policy alone never runs the per-op path under a
    remat label.  Executor cache keys include this pair."""
    from ..flags import FLAGS
    return (FLAGS.whole_graph_ad or bool(FLAGS.remat_policy),
            FLAGS.remat_policy or None)


# ---------------------------------------------------------------------------
# the per-op interpreter
# ---------------------------------------------------------------------------

def _is_generic_grad(op):
    return (op.type.endswith("_grad") and "fwd_uid" in op.attrs
            and not registry.has_op(op.type))


def _gather_inputs(op, env):
    """{slot: [values]}, plus `<slot>@LOD_LEN` (and `<slot>@LOD_SEG`) for
    a slot with a ragged (nested) input."""
    vals = {}
    for slot, names in op.inputs.items():
        vals[slot] = [env.get(n) if n else None for n in names]
        for suf in _COMPANIONS:
            comp = [env.get(n + suf) if n else None for n in names]
            if any(c is not None for c in comp):
                vals[slot + suf] = comp
    return vals


def _write_outputs(op, outs, env):
    """Write a lowering's outputs; an `<slot>@LOD_LEN` or
    `<slot>@LOD_SEG` output is the companion of that slot's vars."""
    for slot, vals in outs.items():
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        suffix = next((s for s in _COMPANIONS if slot.endswith(s)), "")
        names = op.outputs.get(slot[:len(slot) - len(suffix)], [])
        for name, val in zip(names, vals):
            if name and val is not None:
                env[name + suffix] = val


def _propagate_lod(op, env):
    """A LoD-oblivious op (elementwise, fc, activations, ...) keeps the
    ragged structure: its outputs that got no lengths from the lowering
    take the first ragged input's lengths, and its outer counts when
    that input is nested."""
    if op.type in _LOD_DROP_OPS:
        return
    src = next((n for names in op.inputs.values() for n in names
                if n and n + LOD_LEN_SUFFIX in env), None)
    if src is None:
        return
    lens = env[src + LOD_LEN_SUFFIX]
    seg = env.get(src + LOD_SEG_SUFFIX)
    for names in op.outputs.values():
        for n in names:
            if n and n + LOD_LEN_SUFFIX not in env:
                env[n + LOD_LEN_SUFFIX] = lens
                if seg is not None and n + LOD_SEG_SUFFIX not in env:
                    env[n + LOD_SEG_SUFFIX] = seg


def _with_companions(names, env):
    """`names` and the companions that env holds for them."""
    return [m for n in names for m in (n,) + tuple(n + s for s in
                                                   _COMPANIONS)
            if m in env]


def _run_grad_op(op, env, vjp_cache):
    fwd_uid = op.attrs["fwd_uid"]
    entry = vjp_cache.pop(fwd_uid, None)
    if entry is None:
        raise RuntimeError(
            "%s: the forward op (uid %d) did not run in this block before "
            "its grad op" % (op.type, fwd_uid))
    vjp_fn, outs = entry
    cotangents = {}
    for slot, vals in outs.items():
        gnames = op.inputs.get("GRAD:" + slot, [])
        cs = []
        for i, y in enumerate(vals):
            g = env.get(gnames[i]) if i < len(gnames) and gnames[i] \
                else None
            if g is not None and isinstance(y, torch.Tensor):
                g = g.to(y.dtype).reshape(y.shape)
            cs.append(g)
        cotangents[slot] = cs
    grads = vjp_fn(cotangents)
    for slot, gvals in grads.items():
        for name, g in zip(op.outputs.get("GRAD:" + slot, []), gvals):
            if name and g is not None:
                env[name] = g


def _op_tree_writes(op):
    """Names `op` may write to the env, its sub-blocks' writes included
    (a conditional_block declares no outputs but writes its block's
    names back)."""
    writes = {n for ns in op.outputs.values() for n in ns if n}
    sub = op.attrs.get("sub_block")
    if sub is not None:
        for o in sub.ops:
            writes |= _op_tree_writes(o)
    return writes


def _op_tree_reads(op):
    """Names `op` may read from the env, its sub-blocks' reads included;
    an op with a sub-block also reads what its block writes (the current
    value is the carry's start)."""
    reads = {n for ns in op.inputs.values() for n in ns if n}
    sub = op.attrs.get("sub_block")
    if sub is not None:
        for o in sub.ops:
            reads |= _op_tree_reads(o)
        reads |= _op_tree_writes(op)
    return reads


def _touched(op):
    """Names `op` reads or writes in the env.  A generic grad op lists
    its forward op's inputs and outputs but reads only the cotangents
    (the GRAD: slots): its vjp closure holds what it needs."""
    if _is_generic_grad(op):
        names = {n for slot, ns in op.inputs.items()
                 if slot.startswith("GRAD:") for n in ns if n}
        return names | _op_tree_writes(op)
    return _op_tree_reads(op) | _op_tree_writes(op)


def _drop_plan(ops, keep):
    """For each op, the env names that no later op touches: the step
    drops them once the op has run, so an activation or an activation's
    grad lives only as long as the step needs it.  Names in `keep`
    (state, fetches, a segment's outputs) stay."""
    last = {}
    for i, op in enumerate(ops):
        for n in _touched(op):
            last[n] = i
    plan = [[] for _ in ops]
    for n, i in last.items():
        if n not in keep:
            plan[i] += [n] + [n + s for s in _COMPANIONS]
    return plan


def _interpret_ops(ops, env, step=0, seed=0, device=None, drops=None,
                   group=None):
    """Run `ops` in order, mutating env.  An op whose generic grad is
    among `ops` runs under autograd and stashes its vjp; every other op
    runs its lowering in the caller's grad mode.  `drops` (a _drop_plan)
    removes dead names as the ops run; `group` is the data-parallel
    group the lowerings see."""
    needed_vjp = {op.attrs["fwd_uid"] for op in ops if _is_generic_grad(op)}
    vjp_cache = {}
    for i, op in enumerate(ops):
        if _is_generic_grad(op):
            _run_grad_op(op, env, vjp_cache)
        else:
            od = registry.get_op_def(op.type)
            ctx = registry.ExecContext(
                op, _gather_inputs(op, env), step=step, seed=seed,
                device=device, group=group,
                env=env if op.type in _ENV_OPS else None)
            if op.uid in needed_vjp:
                outs, vjp_fn = registry.make_forward_and_vjp(op, od, ctx)
                vjp_cache[op.uid] = (vjp_fn, outs)
            else:
                outs = registry.call_lower(od, ctx)
            _write_outputs(op, outs, env)
            _propagate_lod(op, env)
        if drops is not None:
            for n in drops[i]:
                env.pop(n, None)
    return env


def run_block(block, env, step=0, seed=0, device=None):
    """Interpret `block` eagerly, op by op, mutating env (every value it
    writes stays there)."""
    with torch.no_grad():
        return _interpret_ops(block.ops, env, step=step, seed=seed,
                              device=device)


def run_sub_block(block, env, ctx):
    """Interpret a control-flow op's sub-block over `env` (mutated), with
    the op's step, seed, device and group, in the caller's grad mode."""
    return _interpret_ops(block.ops, env, step=ctx.step, seed=ctx.seed,
                          device=ctx.device, group=ctx.group)


# ---------------------------------------------------------------------------
# the gradient all-reduce of data parallelism
# ---------------------------------------------------------------------------

# the gradient all-reduce's flat fp32 buckets hold at most this many
# bytes each (a tensor larger than that is a bucket of its own)
GRAD_BUCKET_BYTES = 25 << 20


def _grad_buckets(tensors, cap):
    """Consecutive index runs of `tensors` whose fp32 bytes stay within
    `cap` (at least one tensor a run)."""
    buckets, cur, size = [], [], 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * 4
        if cur and size + nbytes > cap:
            buckets.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def all_reduce_grads(grads, group):
    """{name: grad} -> {name: the grad averaged over the group's ranks}:
    flattened in name order (the same on every rank) into fp32 buckets,
    one all_reduce each, then scaled by 1 / world size and cast back.
    With `group.time_grads` the wall time is appended to group.grad_ms
    (a card is synchronized around it).  A group of one without a
    process group returns `grads` as they are."""
    if not group.active or not grads:
        return grads
    names = sorted(grads)
    tensors = [grads[n] for n in names]
    timed = group.time_grads
    if timed:
        if tensors[0].is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
    inv = 1.0 / group.world_size
    out = {}
    with mesh.profiled("grad buckets"):
        for idx in _grad_buckets(tensors, GRAD_BUCKET_BYTES):
            flat = torch.cat([tensors[i].reshape(-1).float() for i in idx])
            group.all_reduce_(flat, "grad")
            if inv != 1.0:
                flat.mul_(inv)
            off = 0
            for i in idx:
                t = tensors[i]
                out[names[i]] = flat[off:off + t.numel()].view(
                    t.shape).to(t.dtype)
                off += t.numel()
    if timed:
        if tensors[0].is_cuda:
            torch.cuda.synchronize()
        group.grad_ms.append((time.perf_counter() - t0) * 1e3)
    return out


def _reduce_state_grads(env, state_names, group):
    """Average, over the ranks, the grads in env of the replicated state
    (the persistables: parameters); a per-sample grad (of a feed or an
    activation) stays the rank's own.  A SelectedRows grad (a sparse
    embedding's) is gathered instead: every rank's rows and values, the
    values scaled by 1 / world size, so that its merge sums what the
    dense all-reduce would average."""
    names = [grad_var_name(n) for n in state_names]
    grads = {g: env[g] for g in names
             if g in env and isinstance(env[g], torch.Tensor)
             and env[g].is_floating_point()}
    env.update(all_reduce_grads(grads, group))
    if not group.active:
        return
    for g in names:
        sr = env.get(g)
        if isinstance(sr, SelectedRowsValue):
            env[g] = SelectedRowsValue(
                group.all_gather_rows(sr.rows),
                group.all_gather_rows(sr.values) / group.world_size,
                sr.height)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def build_step_fn(program, feed_names, fetch_names, state_names,
                  block_idx=0, whole_graph_ad=False, remat_policy=None,
                  device=None, group=None):
    """Return pure fn(state_dict, feed_dict, step) -> (fetches,
    new_state); a fetch no op wrote is None.  With a data-parallel
    `group` it is this rank's part of the global step.

    With whole_graph_ad the backward region is served by ONE
    torch.autograd.grad over the forward region
    (build_whole_graph_step_fn).  An ineligible program falls back to the
    per-op interpreter, except under a remat policy: the per-op path
    cannot rematerialize, so that raises rather than run unlabelled."""
    if whole_graph_ad:
        fn = build_whole_graph_step_fn(
            program, feed_names, fetch_names, state_names,
            block_idx=block_idx, remat_policy=remat_policy, device=device,
            group=group)
        if fn is not None:
            return fn
        has_backward = any(_is_generic_grad(op)
                           for op in program.blocks[block_idx].ops)
        if remat_policy and has_backward:
            raise RuntimeError(
                "remat_policy %r requested but the program is ineligible "
                "for whole-graph AD (control-flow sub-blocks, custom grad "
                "ops, or grads of intermediates)" % (remat_policy,))
    ops = list(program.blocks[block_idx].ops)
    seed = program.random_seed
    state_names = tuple(state_names)
    fetch_names = tuple(fetch_names)
    drops = _drop_plan(ops, set(state_names) | set(fetch_names))
    # with a group the step pauses at the update region's boundary for
    # the gradient all-reduce
    cut = len(ops)
    if group is not None:
        region = _backward_region(ops)
        if region is not None:
            cut = region[1]
            if any(op.type.endswith("_grad") for op in ops[cut:]):
                raise NotImplementedError(
                    "data parallelism: a grad op after the update region "
                    "begins; the gradient all-reduce needs every grad op "
                    "in one backward region")

    def step_fn(state, feeds, step):
        env = dict(state)
        env.update(feeds)
        with torch.no_grad():
            _interpret_ops(ops[:cut], env, step=step, seed=seed,
                           device=device, drops=drops[:cut], group=group)
            if cut < len(ops):
                _reduce_state_grads(env, state_names, group)
                _interpret_ops(ops[cut:], env, step=step, seed=seed,
                               device=device, drops=drops[cut:],
                               group=group)
        fetches = [env.get(n) for n in fetch_names]
        new_state = {n: env[n] for n in state_names if n in env}
        return fetches, new_state

    return step_fn


def run_loop(step_fn, state, feeds, step0, steps):
    """`steps` calls of step_fn on one feed, the step counter folded per
    iteration (step0, step0 + 1, ...) so per-op random streams advance
    as under per-step execution; returns the last step's (fetches,
    state).  The JAX package's jit_loop, as a plain loop."""
    if steps < 1:
        raise ValueError("run_loop: steps must be >= 1")
    fetches = None
    for i in range(steps):
        fetches, state = step_fn(state, feeds, step0 + i)
    return fetches, state


# ---------------------------------------------------------------------------
# whole-graph AD
# ---------------------------------------------------------------------------

def _writes(op):
    return {n for names in op.outputs.values() for n in names if n}


def _is_bwd_helper(op):
    # fan-in accumulation / canonical rebinding emitted by backward.py
    return (op.type in ("sum", "assign")
            and all(GRAD_SUFFIX in n for n in _writes(op)))


def _backward_region(ops):
    """(seed_idx, end) of the backward region of `ops`: from the seed
    fill_constant (the first op that writes only grads) through the grad
    ops and backward.py's fan-in sum/assign ops that follow it; ops[end:]
    is the update region (regularizers, optimizer ops).  None without a
    seed."""
    seed_idx = None
    for i, op in enumerate(ops):
        outs = _writes(op)
        if (op.type == "fill_constant" and outs
                and all(n.endswith(GRAD_SUFFIX) for n in outs)):
            seed_idx = i
            break
    if seed_idx is None:
        return None
    end = seed_idx + 1
    while end < len(ops) and (ops[end].type.endswith("_grad")
                              or _is_bwd_helper(ops[end])):
        end += 1
    return seed_idx, end


def _partition_whole_graph(block):
    """Split block.ops into (forward_ops, update_ops, loss_name) for
    whole-graph AD, or None when the program is ineligible (control-flow
    sub-blocks, custom grad lowerings, several grad seeds, grad-writing
    ops outside the backward region).

    The backward region (`_backward_region`: the seed fill_constant,
    the generic `<type>_grad` ops and their fan-in sum/assign ops) is
    DROPPED: autograd serves it.  Everything after it (regularizers,
    optimizer ops) is the update region and still interprets op by op."""
    ops = list(block.ops)
    region = _backward_region(ops)
    if region is None:
        return None
    seed_idx, end = region
    seed_outs = sorted(_writes(ops[seed_idx]))
    if len(seed_outs) != 1:
        return None
    loss_name = seed_outs[0][:-len(GRAD_SUFFIX)]
    if not all(_is_generic_grad(op) or _is_bwd_helper(op)
               for op in ops[seed_idx + 1:end]):
        return None  # a custom grad lowering needs per-op semantics
    forward_ops, update_ops = ops[:seed_idx], ops[end:]
    for op in forward_ops:
        if op.attrs.get("sub_block") is not None or any(
                GRAD_SUFFIX in n for n in _writes(op)):
            return None
    for op in update_ops:
        if op.attrs.get("sub_block") is not None or \
                op.type.endswith("_grad"):
            return None
    return forward_ops, update_ops, loss_name


class _RematPolicy:
    """How the whole-graph step checkpoints its forward region.

    segment_tags: remat_tag tags that cut the region into segments (each
    segment's inputs are all it keeps); empty: one segment.  save_ops:
    aten ops whose outputs a segment keeps (selective checkpointing);
    None: a segment keeps nothing inside it."""

    def __init__(self, segment_tags=(), save_ops=None):
        self.segment_tags = frozenset(segment_tags)
        self.save_ops = save_ops

    def context_fn(self):
        if self.save_ops is None:
            return torch_checkpoint.noop_context_fn
        save_ops = self.save_ops

        def policy(ctx, op, *args, **kwargs):
            return (torch_checkpoint.CheckpointPolicy.MUST_SAVE
                    if op in save_ops
                    else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)

        return functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, policy)


def _conv_ops():
    return frozenset([torch.ops.aten.convolution.default])


def _dot_ops():
    aten = torch.ops.aten
    return _conv_ops() | frozenset([aten.mm.default, aten.addmm.default,
                                    aten.bmm.default, aten.baddbmm.default])


_KNOWN_TAGS = ("block_out", "conv_out")


def _resolve_remat_policy(policy):
    """The JAX package's policy names, validated (a mistyped tag would
    save nothing and record a maximal-recompute run under a remat label):
      * "nothing": the whole forward region is recomputed in the backward;
      * "dots": matmul and convolution outputs are kept;
      * a comma-separated subset of "block_out" and "conv_out":
        "block_out" cuts the region at the `remat_tag` ops tagged
        block_out (the residual blocks' outputs are kept, their interiors
        recomputed); "conv_out" keeps every convolution's output
        (`aten.convolution`, the JAX package's `checkpoint_name(out,
        "conv_out")`) and recomputes the batch-norm and activation tails.
    None means no remat."""
    if policy is None:
        return None
    if not isinstance(policy, str):
        raise TypeError("remat policy must be a string, got %r"
                        % (policy,))
    if policy == "nothing":
        return _RematPolicy()
    if policy == "dots":
        return _RematPolicy(save_ops=_dot_ops())
    names = [n.strip() for n in policy.split(",") if n.strip()]
    if not names or not set(names) <= set(_KNOWN_TAGS):
        raise ValueError(
            "unknown remat policy %r; expected 'nothing', 'dots' or a "
            "comma-separated subset of %s" % (policy, list(_KNOWN_TAGS)))
    return _RematPolicy(
        segment_tags=["block_out"] if "block_out" in names else (),
        save_ops=_conv_ops() if "conv_out" in names else None)


def _segments(forward_ops, tags):
    """forward_ops cut after every remat_tag op whose tag is in `tags`."""
    segs, cur = [], []
    for op in forward_ops:
        cur.append(op)
        if op.type == "remat_tag" and op.attrs.get("tag") in tags:
            segs.append(cur)
            cur = []
    if cur:
        segs.append(cur)
    return segs


def _reads(op):
    return {n for names in op.inputs.values() for n in names if n}


def _run_segment(ops, drops, out_names, step, seed, device, group, env_in):
    """One segment of the forward region: a fresh env from `env_in`
    (never mutated, so a recomputation sees the first run's inputs);
    returns the written values that later code reads."""
    env = dict(env_in)
    _interpret_ops(ops, env, step=step, seed=seed, device=device,
                   drops=drops, group=group)
    return {n: env[n] for n in _with_companions(out_names, env)}


def build_whole_graph_step_fn(program, feed_names, fetch_names, state_names,
                              block_idx=0, remat_policy=None, device=None,
                              group=None):
    """The whole-graph AD step: fn(state, feeds, step) -> (fetches,
    new_state), with the program's backward region served by one
    torch.autograd.grad over the forward region.

    The forward region runs once under torch.enable_grad() with the
    differentiated vars (the vars whose canonical grads the update
    region or the fetch list reads) as fresh leaves, as segments that
    each keep only what later code reads; under a remat policy each
    segment runs in torch.utils.checkpoint.  What the region writes and
    later code reads (moving statistics, the loss, fetches) is taken,
    detached, from that first run, so a recomputation changes nothing.
    The update region runs op by op under no_grad, after the gradient
    all-reduce when there is a data-parallel `group`.  The backward is
    seeded with the seed op's `value`.

    Returns None when the program is ineligible (see
    _partition_whole_graph, and grads of intermediate vars)."""
    block = program.blocks[block_idx]
    part = _partition_whole_graph(block)
    if part is None:
        return None
    forward_ops, update_ops, loss_name = part
    seed_op = block.ops[_backward_region(block.ops)[0]]
    seed_value = float(seed_op.attrs.get("value", 1.0))
    seed = program.random_seed
    state_names = tuple(state_names)
    fetch_names = tuple(fetch_names)
    policy = _resolve_remat_policy(remat_policy)

    needed_gnames = set()
    for op in update_ops:
        needed_gnames.update(n for n in _reads(op)
                             if n.endswith(GRAD_SUFFIX))
    needed_gnames.update(n for n in fetch_names if n.endswith(GRAD_SUFFIX))
    diff_names = tuple(sorted(n[:-len(GRAD_SUFFIX)] for n in needed_gnames))

    forward_writes = set()
    for op in forward_ops:
        forward_writes |= _writes(op)
    if any(n in forward_writes for n in diff_names):
        return None  # the grad of an intermediate: the per-op path's

    # forward values read after the backward; everything else may die
    # inside the differentiated region (keeping it would pin every
    # activation and defeat remat)
    downstream = set(fetch_names) | set(state_names)
    for op in update_ops:
        downstream |= _reads(op)
    aux_names = tuple(sorted(
        m for n in (downstream & forward_writes) | {loss_name}
        for m in (n,) + tuple(n + s for s in _COMPANIONS)))

    segments = [forward_ops] if policy is None else \
        _segments(forward_ops, policy.segment_tags)
    # (ops, drop plan, inputs, outputs) per segment: a segment returns
    # what a later segment or the update region reads
    plan = []
    later = set(aux_names)
    for seg in reversed(segments):
        written, read = set(), set()
        for op in seg:
            written |= _writes(op)
            read |= _reads(op)
        outs = tuple(sorted(written & later))
        plan.append((seg, _drop_plan(seg, set(outs)), tuple(sorted(read)),
                     outs))
        later |= read
    plan.reverse()
    update_drops = _drop_plan(update_ops,
                              set(state_names) | set(fetch_names))

    def forward(env, step):
        for seg, drops, ins, outs in plan:
            env_in = {n: env[n] for n in _with_companions(ins, env)}
            if policy is None:
                env.update(_run_segment(seg, drops, outs, step, seed,
                                        device, group, env_in))
                continue
            env.update(torch_checkpoint.checkpoint(
                _run_segment, seg, drops, outs, step, seed, device, group,
                env_in,
                use_reentrant=False,
                # the random ops draw from generators seeded per (seed,
                # op, step): a recomputation draws the same values
                preserve_rng_state=False,
                context_fn=policy.context_fn()))
        return env

    def step_fn(state, feeds, step):
        env0 = dict(state)
        env0.update(feeds)
        missing = [n for n in diff_names if n not in env0]
        if missing:
            raise ValueError("whole-graph AD: differentiated vars %s are "
                             "not in state or feeds" % (missing,))
        leaves = [env0[n].detach().requires_grad_(True) for n in diff_names]
        with torch.enable_grad():
            env = dict(env0)
            env.update(zip(diff_names, leaves))
            env = forward(env, step)
            loss = env[loss_name]
            grads = torch.autograd.grad(
                [loss], leaves, [torch.full_like(loss, seed_value)],
                allow_unused=True)
        aux = {n: env[n].detach() for n in aux_names if n in env}
        del env, loss
        env = dict(env0)
        env.update(aux)
        for n, leaf, g in zip(diff_names, leaves, grads):
            env[grad_var_name(n)] = torch.zeros_like(leaf) if g is None \
                else g
        with torch.no_grad():
            if group is not None:
                _reduce_state_grads(env, state_names, group)
            _interpret_ops(update_ops, env, step=step, seed=seed,
                           device=device, drops=update_drops, group=group)
        fetches = [env.get(n) for n in fetch_names]
        new_state = {n: env[n] for n in state_names if n in env}
        return fetches, new_state

    return step_fn
