"""Control-flow op lowerings, after paddle_tpu/ops/control_flow_ops.py:
`while`, `conditional_block`, the tensor arrays (`write_to_array`,
`read_from_array`, `array_length`, `array_to_lod_tensor`,
`lod_tensor_to_array`), `max_sequence_len` and `recurrent`.

Each runs its `sub_block` through the functionalizer's interpreter
(fluid/functionalizer.py run_sub_block), eagerly:
  * `while` is a Python loop over the block, reading its condition on
    the host each trip (the JAX package runs `lax.while_loop`, or a
    bounded masked `lax.scan` under `max_iters`, on the device).  Its
    X / Out slots name the loop's reads and carries, so it is a pure op
    of its inputs; under `max_iters` (not is_test) it stops after that
    many trips, as the bounded scan does;
  * `conditional_block` runs its block over a copy of the env when its
    condition holds and writes back the names the block writes;
  * `recurrent` (DynamicRNN) is a loop over the padded T of its inputs'
    shape — T comes from the shape, so the loop reads nothing back from
    the card — with the JAX lowering's masking: a state past a
    sequence's end keeps its value (`mt * new + (1 - mt) * prev`, in the
    init's dtype under AMP), and the outputs are zero there.
Gradients come from autograd through the loops: an op whose generic
`<type>_grad` follows runs under make_forward_and_vjp (ops/registry.py),
so every trip's ops are recorded and the grad op replays them backwards.
That stands in for the JAX package's recording custom_vjp, its host
replay `while_grad_dynamic` and the scan's own vjp.  The while's grad
maker keeps the JAX package's program structure (the carries' post-loop
partial grads finalized before the generic `while_grad`).

A tensor array is a Python list of tensors in the env, as in the JAX
package; an index read from the card (`I`) is a host read.
"""

import torch

from .registry import register_op, set_grad_maker

# fluid/functionalizer.py LOD_LEN_SUFFIX (imported where it is used: the
# functionalizer imports the op layer)
_LOD = "@LOD_LEN"


def _run(block, env, ctx):
    from ..fluid import functionalizer
    functionalizer.run_sub_block(block, env, ctx)


def _with_companions(names, values, lens):
    """{name: value} plus `<name>@LOD_LEN` for the ragged ones."""
    env = {}
    for n, v, ln in zip(names, values, lens):
        if v is not None:
            env[n] = v
        if ln is not None:
            env[n + _LOD] = ln
    return env


@register_op("while")
def _while(ctx):
    """Condition and X (the block's reads and the carries' starts) in,
    Out (the carries) out; the loop runs while the condition reads true,
    at most `max_iters` trips when that is set (and not is_test).  The
    carries keep their start dtypes (under AMP a body op may promote a
    bf16 carry to fp32)."""
    block = ctx.attr("sub_block")
    cond_name = ctx.op.inputs["Condition"][0]
    x_names = list(ctx.op.inputs.get("X", []))
    out_names = list(ctx.op.outputs.get("Out", []))
    env0 = _with_companions(x_names, ctx.inputs("X"), ctx.lod_lens("X"))
    env0.setdefault(cond_name, ctx.input("Condition"))
    carries = [n for n in out_names if n in env0]
    dtypes = {n: env0[n].dtype for n in carries
              if isinstance(env0[n], torch.Tensor)}
    limit = ctx.attr("max_iters") if not ctx.attr("is_test", False) \
        else None
    env, trips = env0, 0
    while bool(env[cond_name].reshape(())) and \
            (not limit or trips < int(limit)):
        env = dict(env)
        _run(block, env, ctx)
        for n, dt in dtypes.items():
            if env[n].dtype != dt:
                env[n] = env[n].to(dt)
        trips += 1
    return {"Out": [env.get(n) for n in out_names],
            "Out@LOD_LEN": [env.get(n + _LOD) for n in out_names]}


def _while_grad_maker(op, block, grad_map, no_grad_set, bw_ctx=None):
    """Finalize each carry's post-loop partial grads (a carry with a
    pre-loop consumer still holds them as partials when the reverse walk
    reaches the loop: they are the loop's out-grads), then decline to
    the generic `while_grad`, which differentiates the recorded trips.
    The JAX package's maker, for every loop but its host-replay one."""
    from ..fluid.backward import _create_grad_var
    from ..fluid.framework import grad_var_name
    partials = (bw_ctx or {}).get("partials", {})
    for n in op.outputs.get("Out", []):
        if n in grad_map:
            continue
        parts = partials.pop(n, [])
        if not parts:
            continue
        gname = grad_var_name(n)
        v = block._find_var_recursive(n)
        if not block.has_var(gname) and v is not None:
            _create_grad_var(block, v, gname)
        if len(parts) == 1:
            block.append_op(type="assign", inputs={"X": [parts[0]]},
                            outputs={"Out": [gname]}, infer_shape=False)
        else:
            block.append_op(type="sum", inputs={"X": parts},
                            outputs={"Out": [gname]}, infer_shape=False)
        grad_map[n] = gname
    return None


set_grad_maker("while", _while_grad_maker)


@register_op("conditional_block")
def _conditional_block(ctx):
    """When Cond holds, run the block over a copy of the env and write
    back the names it writes that the env held before (the carries)."""
    env = ctx.env
    if not bool(ctx.input("Cond").reshape(())):
        return {}
    from ..fluid.functionalizer import _op_tree_writes
    e = dict(env)
    _run(ctx.attr("sub_block"), e, ctx)
    for n in _op_tree_writes(ctx.op):
        if n in env:
            env[n] = e[n]
            if n + _LOD in e:
                env[n + _LOD] = e[n + _LOD]
    return {}


def _index(i):
    return int(i.reshape(()))


@register_op("write_to_array")
def _write_to_array(ctx):
    """Out[I] = X on a copy of the array the env holds under Out's name
    (a new one if it holds none), grown with None to reach I."""
    name = ctx.op.outputs["Out"][0]
    arr = ctx.env.get(name)
    arr = list(arr) if isinstance(arr, list) else []
    i = _index(ctx.input("I"))
    while len(arr) <= i:
        arr.append(None)
    arr[i] = ctx.input("X")
    ctx.env[name] = arr
    return {}


@register_op("read_from_array")
def _read_from_array(ctx):
    return {"Out": ctx.input("X")[_index(ctx.input("I"))]}


@register_op("array_length")
def _array_length(ctx):
    return {"Out": torch.tensor([len(ctx.input("X"))], dtype=torch.int64,
                                device=ctx.device)}


@register_op("array_to_lod_tensor")
def _array_to_lod_tensor(ctx):
    return {"Out": torch.stack(ctx.input("X"), dim=1)}  # [B, T, ...]


@register_op("lod_tensor_to_array")
def _lod_tensor_to_array(ctx):
    return {"Out": [list(torch.unbind(ctx.input("X"), dim=1))]}


@register_op("max_sequence_len")
def _max_sequence_len(ctx):
    lens = ctx.lod_len("RankTable")
    if lens is None:
        raise ValueError("max_sequence_len: RankTable carries no lengths")
    return {"Out": lens.max().reshape(1).to(torch.int64)}


@register_op("recurrent")
def _recurrent(ctx):
    """X: the step inputs [B, T, ...] (ragged); InitStates; Params: the
    block's outside reads (with their lengths, so a sequence op inside
    masks a ragged static input).  The block maps the step slices
    (`seq_input_names`) and the previous states (`state_prev_names`) to
    the new states (`state_names`) and the step outputs
    (`output_names`).  Out [B, T, ...] carries X's lengths."""
    block = ctx.attr("sub_block")
    seq_names = ctx.attr("seq_input_names")
    state_names = ctx.attr("state_names")
    state_prev_names = ctx.attr("state_prev_names")
    out_names = ctx.attr("output_names")
    param_names = ctx.attr("param_names", [])
    xs = ctx.inputs("X")
    params = _with_companions(param_names, ctx.inputs("Params"),
                              ctx.lod_lens("Params"))
    B, T = xs[0].shape[0], xs[0].shape[1]
    lens = ctx.lod_len("X")
    if lens is None:
        lens = torch.full((B,), T, dtype=torch.int32, device=xs[0].device)
    mask = (torch.arange(T, device=lens.device)[None, :]
            < lens[:, None]).to(xs[0].dtype)                 # [B, T]
    states = list(ctx.inputs("InitStates"))
    steps = [torch.unbind(x, dim=1) for x in xs]
    outs = [[] for _ in out_names]
    for t in range(T):
        mt = mask[:, t, None]                                 # [B, 1]
        e = dict(params)
        e.update(zip(seq_names, (s[t] for s in steps)))
        e.update(zip(state_prev_names, states))
        _run(block, e, ctx)
        states = [(mt * e[n] + (1 - mt) * prev).to(prev.dtype)
                  for prev, n in zip(states, state_names)]
        for acc, n in zip(outs, out_names):
            acc.append(e[n] * mt)
    out_vals = [torch.stack(o, dim=1) for o in outs]
    return {"Out": out_vals, "Out@LOD_LEN": [lens] * len(out_vals),
            "FinalStates": states}
