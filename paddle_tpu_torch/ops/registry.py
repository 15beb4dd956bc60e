"""Op registry — the port's kernel layer, after paddle_tpu/ops/registry.py.

Each op registers ONE lowering `lower(ctx) -> {out_slot: value}` on torch
tensors.  The Executor (fluid/executor.py) interprets a Block eagerly, op
by op, calling these lowerings on the Executor's device.

Autodiff: every op gets a generic grad op `<type>_grad` (fluid/backward.py).
A forward op whose grad is needed runs under `torch.enable_grad()` with
its float inputs as fresh leaves (`make_forward_and_vjp`); the closure it
returns calls `torch.autograd.grad` over that op's own graph, and the
matching grad op consumes it.  No per-op gradient code, and each op's
graph lives only until its grad op has run.

Shape inference: `infer_shape(op, block)` runs the lowering on
`device="meta"` tensors (shapes and dtypes, no data), substituting a dummy
extent for the batch placeholder -1 and restoring it on the outputs.

bf16 AMP (`set_amp(True)`): `call_lower` casts the inputs of AMP_WHITE
ops to bf16 and of AMP_BLACK ops to fp32 before the lowering runs, inside
the call that `make_forward_and_vjp` differentiates, so fp32 master
weights receive fp32 gradients.
"""

import torch
import torch.utils.checkpoint

__all__ = ["OpDef", "ExecContext", "OpError", "register_op", "get_op_def",
           "has_op", "registered_ops", "infer_shape",
           "make_forward_and_vjp", "call_lower", "set_amp", "amp_enabled",
           "AMP_WHITE", "AMP_BLACK"]

_REGISTRY = {}

# dummy extents substituted for -1 during shape inference; recognised in
# output shapes and mapped back to -1, so one must not collide with any
# real static dim of the op
_DUMMY_CANDIDATES = (97, 811, 1327, 2957)

_MASK64 = (1 << 64) - 1


class OpDef:
    def __init__(self, type, lower, infer_shape=None):
        self.type = type
        self.lower = lower
        # shape inference of its own, for an op whose lowering cannot
        # run on the build-time shapes (a ragged op sees the packed
        # [rows, ...] layout there, the padded [B, T, ...] one at run
        # time)
        self.custom_infer_shape = infer_shape


def _mix_seed(*vals):
    """splitmix64 over the values: a 63-bit torch.Generator seed that
    changes with every one of them."""
    h = 0
    for v in vals:
        h = ((h ^ (int(v) & _MASK64)) + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h >> 1


class ExecContext:
    """What a lowering sees: attrs, resolved input tensors, the step, the
    program's random seed, the device it computes on and the
    data-parallel group (parallel/mesh.py DataParallelGroup, as the JAX
    context carries its mesh): None on one device; under a group a
    lowering that reduces over the batch axis sums over the ranks."""

    __slots__ = ("op", "attrs", "_inputs", "step", "seed", "device",
                 "group")

    def __init__(self, op, inputs, step=0, seed=0, device=None, group=None):
        self.op = op
        self.attrs = op.attrs
        self._inputs = inputs  # slot -> [values]
        self.step = step
        self.seed = seed
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        self.group = group

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def input(self, slot):
        """Single input value for slot (None if absent)."""
        vs = self._inputs.get(slot)
        if not vs:
            return None
        return vs[0]

    def inputs(self, slot):
        return self._inputs.get(slot, [])

    def has_input(self, slot):
        return bool(self._inputs.get(slot))

    def batch_sharded(self, name):
        """True when var `name` holds this rank's share of the global
        batch: a world of several ranks, and a non-persistable var whose
        program shape leads with the batch axis (-1)."""
        if self.group is None or self.group.world_size < 2:
            return False
        v = self.op.block._find_var_recursive(name)
        return bool(v is not None and not v.persistable
                    and v.shape is not None and len(v.shape) > 0
                    and (v.shape[0] is None or v.shape[0] < 0))

    def lod_len(self, slot):
        """The int32 [B] sequence lengths of a ragged (LoD) input, or
        None for a dense one (fluid/functionalizer.py LOD_LEN_SUFFIX)."""
        vs = self._inputs.get(slot + "@LOD_LEN")
        return vs[0] if vs else None

    def lod_lens(self, slot):
        """The lengths of EVERY input of a multi-input slot, aligned with
        inputs(slot); None entries for dense inputs."""
        vs = self._inputs.get(slot + "@LOD_LEN")
        return vs if vs else [None] * len(self._inputs.get(slot, []))

    def generator(self):
        """A torch.Generator on the context's device, seeded from the
        op's `seed` attr, the program's random seed, the op's uid and the
        step: two identically built programs draw the same values, and
        every step draws anew.  In a world of several ranks the rank is
        mixed in too, so the ranks' rows get independent draws (not the
        JAX package's bits for the global batch: its masks change with
        the sharding as well).  None on the meta device (no data)."""
        if self.device.type == "meta":
            return None
        g = torch.Generator(device=self.device)
        vals = [self.attr("seed", 0) or 0, self.seed or 0, self.op.uid,
                self.step]
        if self.group is not None and self.group.world_size > 1:
            # each rank draws for its own rows
            vals.append(self.group.rank)
        g.manual_seed(_mix_seed(*vals))
        return g


def register_op(type, infer_shape=None):
    """Register an op's lowering: @register_op("relu"); `infer_shape(op,
    block)` replaces the meta-tensor shape inference."""
    def deco(fn):
        _REGISTRY[type] = OpDef(type, fn, infer_shape=infer_shape)
        return fn
    return deco


def get_op_def(type):
    od = _REGISTRY.get(type)
    if od is None:
        raise NotImplementedError(
            "op '%s' is not registered in paddle_tpu_torch's op registry"
            % type)
    return od


def has_op(type):
    return type in _REGISTRY


def registered_ops():
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# shape inference on meta tensors
# ---------------------------------------------------------------------------

def _pick_dummy(op, block):
    """A dummy batch extent that appears in no input's static dims."""
    static = set()
    for names in op.inputs.values():
        for n in names:
            v = block._find_var_recursive(n)
            if v is not None and v.shape is not None:
                static.update(int(d) for d in v.shape
                              if d is not None and d >= 0)
    for c in _DUMMY_CANDIDATES:
        if c not in static:
            return c
    return max(static) + 101


def _subst_dummy(shape, dummy):
    return tuple(dummy if d is None or d < 0 else int(d) for d in shape)


def _restore_dummy(shape, had_dynamic, dummy):
    if not had_dynamic:
        return tuple(int(d) for d in shape)
    return tuple(-1 if d == dummy else int(d) for d in shape)


def infer_shape(op, block):
    """Fill in shape/dtype of op's output Variables by running the
    lowering on meta tensors.  Best-effort: an op whose inputs are not
    shaped, or whose lowering cannot run on meta tensors, is skipped (the
    Executor still produces the right runtime shapes)."""
    od = _REGISTRY.get(op.type)
    if od is None:
        return
    if od.custom_infer_shape is not None:
        od.custom_infer_shape(op, block)
        return
    from ..fluid import core as fcore

    dummy = _pick_dummy(op, block)
    ins = {}
    had_dynamic = False
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            v = block._find_var_recursive(n)
            if v is None or v.shape is None:
                return
            if any(d is None or d < 0 for d in v.shape):
                had_dynamic = True
            vals.append(torch.empty(_subst_dummy(v.shape, dummy),
                                    dtype=fcore.convert_dtype_to_torch(
                                        v.dtype),
                                    device="meta"))
        ins[slot] = vals
    try:
        with torch.no_grad():
            out = od.lower(ExecContext(op, ins, step=0, seed=0,
                                       device="meta"))
    except (RuntimeError, NotImplementedError, TypeError, ValueError,
            IndexError):
        return
    if out is None:
        return
    for slot, vals in out.items():
        names = op.outputs.get(slot, [])
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for n, s in zip(names, vals):
            v = block._find_var_recursive(n)
            if v is None or not isinstance(s, torch.Tensor):
                continue
            v.shape = _restore_dummy(tuple(s.shape), had_dynamic, dummy)
            v.dtype = fcore.convert_torch_dtype_to_dtype_(s.dtype)


# ---------------------------------------------------------------------------
# generic autograd-based gradients
# ---------------------------------------------------------------------------

def _is_float(x):
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _normalize(outs):
    return {s: list(v) if isinstance(v, (list, tuple)) else [v]
            for s, v in outs.items()}


def make_forward_and_vjp(op, od, ctx):
    """Run the forward with its float inputs as fresh autograd leaves.

    Returns (outputs, vjp_fn): outputs as {slot: [tensors]} detached from
    the graph, and vjp_fn mapping output cotangents {slot: [tensor or
    None]} to input grads in the same dict-of-lists layout — None for
    non-float inputs, zeros for float inputs the outputs do not depend
    on.  A None cotangent (or one for a non-float output) is a zero
    cotangent.  vjp_fn runs once: it frees the op's graph."""
    in_layout = [(slot, len(vals)) for slot, vals in ctx._inputs.items()]
    flat_in = [v for _, vals in ctx._inputs.items() for v in vals]
    diff_idx = [i for i, v in enumerate(flat_in) if _is_float(v)]

    with torch.enable_grad():
        leaves = [flat_in[i].detach().requires_grad_(True)
                  for i in diff_idx]
        flat = list(flat_in)
        for i, leaf in zip(diff_idx, leaves):
            flat[i] = leaf
        d, k = {}, 0
        for slot, n in in_layout:
            d[slot] = flat[k:k + n]
            k += n
        outs = _normalize(call_lower(od, ExecContext(
            op, d, step=ctx.step, seed=ctx.seed, device=ctx.device,
            group=ctx.group)))

    def vjp_to_slots(cotangents):
        ys, gs = [], []
        for slot, vals in outs.items():
            cs = cotangents.get(slot, [])
            for i, y in enumerate(vals):
                c = cs[i] if i < len(cs) else None
                if c is None or not isinstance(y, torch.Tensor) \
                        or not y.requires_grad:
                    continue
                ys.append(y)
                gs.append(c)
        grads = [None] * len(leaves)
        if ys and leaves:
            grads = torch.autograd.grad(ys, leaves, gs, allow_unused=True)
        flat_grads = [None] * len(flat_in)
        for i, leaf, g in zip(diff_idx, leaves, grads):
            flat_grads[i] = torch.zeros_like(leaf) if g is None else g
        res, k = {}, 0
        for slot, n in in_layout:
            res[slot] = flat_grads[k:k + n]
            k += n
        return res

    detached = {s: [v.detach() if isinstance(v, torch.Tensor) else v
                    for v in vals] for s, vals in outs.items()}
    return detached, vjp_to_slots


# ---------------------------------------------------------------------------
# automatic mixed precision (bf16 compute, fp32 master weights), after the
# JAX registry: the lists are its lists, and the casts live inside the
# differentiated lowering call
# ---------------------------------------------------------------------------

_AMP = {"enabled": False}

# compute-bound ops: their float inputs go to bf16 (the card's tensor
# cores, the TPU's MXU in the JAX package)
AMP_WHITE = frozenset([
    "conv2d", "depthwise_conv2d", "conv3d", "conv2d_transpose",
    "conv3d_transpose", "mul", "matmul", "flash_attention",
])

# numerically sensitive ops: force fp32 inputs. batch_norm is not here:
# its lowering normalizes in the input dtype with fp32 statistics, so
# forcing fp32 inputs would only double every activation's bytes.
AMP_BLACK = frozenset([
    "softmax", "softmax_with_cross_entropy", "cross_entropy",
    "sigmoid_cross_entropy_with_logits", "layer_norm",
    "group_norm", "mean", "reduce_mean", "reduce_sum", "sum", "exp", "log",
    "sequence_softmax", "log_softmax", "linear_chain_crf", "warpctc",
    # optimizer updates accumulate in fp32 master weights
    "sgd", "momentum", "lars_momentum", "adam", "adamax", "adagrad",
    "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "proximal_gd",
])


def set_amp(enabled):
    _AMP["enabled"] = bool(enabled)


def amp_enabled():
    return _AMP["enabled"]


def _amp_cast(vals, to_dtype):
    """fp32 and bf16 tensors of `vals` cast to `to_dtype`; anything else
    (ints, None) as it is."""
    out = []
    for v in vals:
        if isinstance(v, torch.Tensor) and \
                v.dtype in (torch.float32, torch.bfloat16) and \
                v.dtype != to_dtype:
            v = v.to(to_dtype)
        out.append(v)
    return out


def _amp_context(od, ctx):
    """The context the lowering sees: under AMP, a white op's float
    inputs in bf16 and a black op's in fp32 (`@LOD_LEN` length companions
    are never cast); otherwise `ctx` itself."""
    if not _AMP["enabled"]:
        return ctx
    if od.type in AMP_WHITE:
        to = torch.bfloat16
    elif od.type in AMP_BLACK:
        to = torch.float32
    else:
        return ctx
    inputs = {slot: vals if slot.endswith("@LOD_LEN")
              else _amp_cast(vals, to)
              for slot, vals in ctx._inputs.items()}
    return ExecContext(ctx.op, inputs, step=ctx.step, seed=ctx.seed,
                       device=ctx.device, group=ctx.group)


class OpError(RuntimeError):
    """An op lowering failed; the message carries the op's identity and
    its inputs' shapes/dtypes."""


# raised through a lowering, never by one: torch.utils.checkpoint stops a
# recomputation early by raising this from a saved-tensor hook
_CONTROL_FLOW = tuple(
    getattr(torch.utils.checkpoint, name) for name in
    ("_StopRecomputationError",)
    if hasattr(torch.utils.checkpoint, name))


def _describe_inputs(op, inputs):
    lines = []
    for slot, names in op.inputs.items():
        vals = inputs.get(slot, [])
        for i, n in enumerate(names):
            v = vals[i] if i < len(vals) else None
            if v is None:
                desc = "<missing>"
            elif isinstance(v, torch.Tensor):
                desc = "shape=%s dtype=%s device=%s" % (
                    tuple(v.shape), v.dtype, v.device)
            else:
                desc = type(v).__name__
            lines.append("    %s[%d] '%s': %s" % (slot, i, n, desc))
    return lines


def call_lower(od, ctx):
    """All lowering calls go through here so (a) the AMP casts sit inside
    the differentiated call and (b) a failure re-raises with the op's
    type, input names/shapes/dtypes and attrs."""
    try:
        return od.lower(_amp_context(od, ctx))
    except (OpError, NotImplementedError) + _CONTROL_FLOW:
        raise
    except Exception as e:
        lines = ["%s: %s" % (type(e).__name__, e),
                 "  [operator context] op '%s' failed during lowering"
                 % od.type]
        lines += _describe_inputs(ctx.op, ctx._inputs)
        attrs = {}
        for k, v in ctx.attrs.items():
            if k.startswith("fwd_"):
                continue
            r = repr(v)
            attrs[k] = r if len(r) <= 200 else r[:200] + "...<truncated>"
        if attrs:
            lines.append("    attrs: %s" % attrs)
        raise OpError("\n".join(lines)) from e
