"""Program-level autodiff: append_backward, a copy of
paddle_tpu/fluid/backward.py.

Every forward op on the path from the parameters to the loss gets ONE
generic grad op `<type>_grad` carrying `fwd_uid`; the Executor runs the
forward op under autograd and hands its vjp closure to the grad op
(ops/registry.py).  The program structure — grad vars named `X@GRAD`,
`sum` ops merging fan-in, fill_constant(1) seeding the loss grad — is the
JAX package's, op for op.  An op with its own grad maker (OpDef.
grad_maker: the `while`'s, ops/control_flow_ops.py) emits its grad ops
itself or declines to the generic one; it joins the fan-in protocol
through `bw_ctx` (the pending consumer counts and the partial grads).
A `while` carry is read and written by the loop, which is therefore not
counted as its consumer.  Error clipping is not ported.
"""

from .framework import Variable, grad_var_name

__all__ = ["append_backward", "calc_gradient", "gradients"]


def _create_grad_var(block, ref_var, grad_name):
    if block.has_var(grad_name):
        return block.var(grad_name)
    return block.create_var(
        name=grad_name, shape=ref_var.shape, dtype=ref_var.dtype,
        lod_level=ref_var.lod_level, persistable=False)


def _op_path(block, target_names, start_names, no_grad_set):
    """Ops on a path from `start_names` to the targets: forward
    reachability from the start set intersected with the backward walk
    from the targets."""
    reachable = set(start_names)
    fwd_ops = set()
    for op in block.ops:
        if set(op.input_arg_names) & reachable:
            fwd_ops.add(id(op))
            reachable.update(op.output_arg_names)
    relevant = set(target_names)
    path = []
    for op in reversed(block.ops):
        if id(op) not in fwd_ops:
            continue
        if set(op.output_arg_names) & relevant:
            path.append(op)
            for name in op.input_arg_names:
                if name not in no_grad_set:
                    relevant.add(name)
    path.reverse()
    return path


def _append_grad_ops(block, path_ops, grad_map, no_grad_set):
    """Walk `path_ops` in reverse emitting `<type>_grad` ops.

    grad_map: var name -> grad var name.  A var consumed by several ops
    gets one renamed partial grad per consumer, merged by a `sum` op."""
    # how many path ops consume each var (fan-out forward = fan-in
    # backward); an op reading and writing one name is not its consumer
    pending = {}
    for op in path_ops:
        outs = set(op.output_arg_names)
        for name in set(op.input_arg_names) - outs:
            pending[name] = pending.get(name, 0) + 1

    partials = {}  # var name -> list of partial grad var names

    def finalize_grad(name):
        parts = partials.pop(name, [])
        if not parts:
            return
        gname = grad_var_name(name)
        if not block.has_var(gname):
            v = block._find_var_recursive(name)
            if v is not None:
                _create_grad_var(block, v, gname)
        if len(parts) == 1:
            if parts[0] != gname:
                block.append_op(type="assign", inputs={"X": parts[0]},
                                outputs={"Out": gname}, infer_shape=False)
        else:
            block.append_op(type="sum", inputs={"X": parts},
                            outputs={"Out": gname}, infer_shape=False)
        grad_map[name] = gname

    from ..ops import registry

    for op in reversed(path_ops):
        # a while carry with a pre-loop consumer holds its post-loop
        # contributions as partials (the pre-loop consumer is still owed):
        # the while's grad maker finalizes them, so they count as grads
        if not any(name in grad_map
                   or (op.type == "while" and partials.get(name))
                   for name in op.output_arg_names):
            continue

        od = registry.get_op_def(op.type) if registry.has_op(op.type) \
            else None
        if od is not None and od.grad_maker is not None:
            made = od.grad_maker(op, block, grad_map, no_grad_set,
                                 {"pending": pending, "partials": partials})
            if made is not None:
                for name in set(op.input_arg_names) - \
                        set(op.output_arg_names):
                    if name in pending:
                        pending[name] -= 1
                        if pending[name] == 0 and name in partials:
                            finalize_grad(name)
                continue

        grad_inputs = {}
        for slot, names in op.inputs.items():
            grad_inputs[slot] = list(names)
        for slot, names in op.outputs.items():
            grad_inputs["Out:" + slot] = list(names)
            grad_inputs["GRAD:" + slot] = [grad_map.get(n, "")
                                           for n in names]

        grad_outputs = {}
        any_grad_out = False
        for slot, names in op.inputs.items():
            gnames = []
            for n in names:
                v = block._find_var_recursive(n)
                if n in no_grad_set or v is None or v.stop_gradient:
                    gnames.append("")
                    continue
                gname = grad_var_name(n)
                # rename whenever another partial exists or more are owed;
                # otherwise the base name, which later grad ops read
                if pending.get(n, 0) > 1 or partials.get(n):
                    gname = gname + "@RENAME@%d" % len(
                        partials.setdefault(n, []))
                    partials[n].append(gname)
                else:
                    partials.setdefault(n, []).append(gname)
                _create_grad_var(block, v, gname)
                gnames.append(gname)
                any_grad_out = True
            grad_outputs["GRAD:" + slot] = gnames
        if any_grad_out:
            block.append_op(
                type=op.type + "_grad",
                inputs=grad_inputs, outputs=grad_outputs,
                attrs={"fwd_uid": op.uid, "fwd_type": op.type,
                       "fwd_attrs": dict(op.attrs)},
                infer_shape=False)

        # a consumer of each input var has now contributed its partial
        for name in set(op.input_arg_names) - set(op.output_arg_names):
            if name in pending:
                pending[name] -= 1
                if pending[name] == 0 and name in partials:
                    finalize_grad(name)
    # vars consumed by ops off the path
    for name in list(partials):
        finalize_grad(name)


def append_backward(loss, parameter_list=None, no_grad_set=None):
    """Append grad ops for `loss` to its program; return [(param,
    param_grad)]."""
    if not isinstance(loss, Variable):
        raise TypeError("append_backward: loss must be a Variable")
    block = loss.block.program.global_block()
    no_grad = set(no_grad_set or [])
    for v in block.vars.values():
        if v.stop_gradient:
            no_grad.add(v.name)
        if v.error_clip is not None:
            raise NotImplementedError(
                "append_backward: error_clip on %s is not ported to "
                "paddle_tpu_torch yet" % v.name)

    if parameter_list is not None:
        params = [p if isinstance(p, str) else p.name
                  for p in parameter_list]
    else:
        params = [p.name for p in block.all_parameters()
                  if getattr(p, "trainable", True)]

    # seed: d loss / d loss = 1
    loss_grad = grad_var_name(loss.name)
    _create_grad_var(block, loss, loss_grad)
    block.append_op(
        type="fill_constant",
        outputs={"Out": [loss_grad]},
        attrs={"shape": list(loss.shape) if loss.shape else [1],
               "value": 1.0, "dtype": loss.dtype,
               "op_role": "Backward"},
        infer_shape=False)

    grad_map = {loss.name: loss_grad}
    path = _op_path(block, [loss.name], params, no_grad)
    _append_grad_ops(block, path, grad_map, no_grad)

    params_and_grads = []
    for pname in params:
        gname = grad_map.get(pname)
        if gname is None or not block.has_var(gname):
            continue
        params_and_grads.append((block.var(pname), block.var(gname)))
    return params_and_grads


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Grads of `targets` (each seeded with 1, or its target gradient)
    with respect to `inputs`: a list aligned with `inputs`, None where
    no path leads."""
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    block = targets[0].block
    no_grad = set(no_grad_set or [])
    grad_map = {}
    for i, t in enumerate(targets):
        gname = grad_var_name(t.name)
        _create_grad_var(block, t, gname)
        if target_gradients is not None and target_gradients[i] is not None:
            block.append_op(type="assign",
                            inputs={"X": target_gradients[i].name},
                            outputs={"Out": gname}, infer_shape=False)
        else:
            block.append_op(
                type="fill_constant", outputs={"Out": [gname]},
                attrs={"shape": list(t.shape) if t.shape else [1],
                       "value": 1.0, "dtype": t.dtype},
                infer_shape=False)
        grad_map[t.name] = gname
    path = _op_path(block, [t.name for t in targets],
                    [v.name for v in inputs], no_grad)
    _append_grad_ops(block, path, grad_map, no_grad)
    return [block.var(grad_map[v.name]) if v.name in grad_map
            and block.has_var(grad_map[v.name]) else None for v in inputs]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    return calc_gradient(targets, inputs, target_gradients, no_grad_set)
