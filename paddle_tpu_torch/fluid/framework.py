"""Program/Block/Operator/Variable graph IR, a copy of
paddle_tpu/fluid/framework.py.

A control-flow layer builds its sub-block with `Program._create_block`
(the new block becomes the current one, child of the block that was)
and returns with `_rollback`; the op that runs it holds the block in
its `sub_block` attr, which serializes as `{"__block__": idx}` (inside a
container attr too), so clone, `serialize_to_string` and the inference
artifacts keep sub-blocks.

One in-memory graph object per program: the IR's job is program
construction, autodiff and serialization; the Executor (executor.py)
interprets a block op by op.  Shape and dtype inference is delegated to
the op registry, which runs the op's torch lowering on meta tensors
(ops/registry.py) — never JAX.

`serialize_to_string` writes the JAX package's JSON, key for key, and
`parse_from_string` reads it: a program (and so an inference artifact's
`__model__`) saved by either package loads in the other.
"""

import collections
import contextlib
import json

import numpy as np

from . import core, unique_name
from .core import VarDesc, convert_np_dtype_to_dtype_

__all__ = [
    "Program", "Block", "Variable", "Operator", "Parameter",
    "default_startup_program", "default_main_program", "program_guard",
    "grad_var_name", "name_scope",
]

GRAD_VAR_SUFFIX = "@GRAD"


def grad_var_name(var_name):
    return var_name + GRAD_VAR_SUFFIX


class Variable:
    """A named tensor slot in a Block."""

    def __init__(self, block, type=VarDesc.VarType.LOD_TENSOR, name=None,
                 shape=None, dtype=None, lod_level=None, capacity=None,
                 persistable=None, error_clip=None, stop_gradient=False,
                 is_data=False, initializer=None, **kwargs):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.type = type
        self.shape = tuple(shape) if shape is not None else None
        if dtype is not None and not isinstance(dtype, int):
            dtype = convert_np_dtype_to_dtype_(dtype)
        self.dtype = dtype if dtype is not None else VarDesc.VarType.FP32
        self.lod_level = lod_level if lod_level is not None else 0
        self.persistable = bool(persistable) if persistable is not None \
            else False
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.error_clip = error_clip
        self.op = None  # generating op, set by Block.append_op

    def astype(self, dtype):
        from .layers import tensor as tensor_layers
        return tensor_layers.cast(self, dtype)

    @property
    def grad_name(self):
        return grad_var_name(self.name)

    @property
    def torch_dtype(self):
        return core.convert_dtype_to_torch(self.dtype)

    @property
    def np_dtype(self):
        return core.convert_dtype_to_np(self.dtype)

    def __repr__(self):
        return "Variable(name=%s, shape=%s, dtype=%s, lod_level=%d%s)" % (
            self.name, self.shape, self.torch_dtype, self.lod_level,
            ", persistable" if self.persistable else "")

    __str__ = __repr__

    def _serialize(self):
        return {
            "name": self.name, "type": self.type,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype, "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "is_parameter": isinstance(self, Parameter),
            "trainable": getattr(self, "trainable", None),
        }


class Parameter(Variable):
    """A persistable, trainable Variable."""

    def __init__(self, block, shape, dtype, **kwargs):
        if shape is None or dtype is None:
            raise ValueError("Parameter needs shape and dtype")
        kwargs.setdefault("persistable", True)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)
        self.trainable = kwargs.get("trainable", True)
        self.optimize_attr = kwargs.get("optimize_attr",
                                        {"learning_rate": 1.0})
        self.regularizer = kwargs.get("regularizer", None)
        self.gradient_clip_attr = kwargs.get("gradient_clip_attr", None)
        self.do_model_average = kwargs.get("do_model_average", None)


_name_scope_stack = []


@contextlib.contextmanager
def name_scope(prefix=None):
    """Ops appended inside carry the '/'-joined prefixes of the open
    scopes in their `op_namescope` attr (a debugging label)."""
    if prefix:
        _name_scope_stack.append(prefix)
    try:
        yield
    finally:
        if prefix:
            _name_scope_stack.pop()


class Operator:
    """One node in a Block: slot name -> list of variable names for inputs
    and outputs, plus plain-python attributes."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {}   # slot -> [var names]
        self.outputs = {}  # slot -> [var names]
        self.attrs = dict(attrs) if attrs else {}
        if _name_scope_stack:
            self.attrs.setdefault("op_namescope", "/".join(_name_scope_stack))
        # uid is per-program creation order: the per-op RNG stream folds
        # it in, so two identically built programs draw identical values
        self.uid = block.program._next_op_uid()

        def norm(d, target):
            if d is None:
                return
            for slot, vs in d.items():
                if vs is None:
                    target[slot] = []
                    continue
                if not isinstance(vs, (list, tuple)):
                    vs = [vs]
                target[slot] = [v.name if isinstance(v, Variable) else v
                                for v in vs]

        norm(inputs, self.inputs)
        norm(outputs, self.outputs)

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    @property
    def output_arg_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def __repr__(self):
        return "Operator(%s: %s -> %s)" % (self.type, self.inputs,
                                           self.outputs)

    __str__ = __repr__

    @staticmethod
    def _encode_attr(v):
        """JSON form of one attr value (recursive, as a Block or an
        ndarray may sit inside a container attr)."""
        if isinstance(v, Block):
            return {"__block__": v.idx}
        if isinstance(v, np.ndarray):
            return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
        if isinstance(v, dict):
            return {k: Operator._encode_attr(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [Operator._encode_attr(x) for x in v]
        return v

    def _serialize(self):
        attrs = {k: self._encode_attr(v) for k, v in self.attrs.items()}
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs, "attrs": attrs, "uid": self.uid}


class Block:
    """An ordered op list + var map."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = collections.OrderedDict()  # name -> Variable
        self.ops = []
        self.forward_block_idx = -1

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise ValueError("var %s not in block %d" % (name, self.idx))
        return v

    def has_var(self, name):
        return name in self.vars

    def _var_recursive(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        raise ValueError("var %s not found in block hierarchy" % name)

    def _find_var_recursive(self, name):
        try:
            return self._var_recursive(name)
        except ValueError:
            return None

    def create_var(self, **kwargs):
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        v = Variable(self, **kwargs)
        self.vars[v.name] = v
        return v

    def create_parameter(self, **kwargs):
        p = Parameter(self, **kwargs)
        # parameters live in the global (root) block
        gb = self.program.global_block()
        gb.vars[p.name] = p
        p.block = gb
        return p

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type=None, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        op = Operator(self, type=type, inputs=inputs, outputs=outputs,
                      attrs=attrs)
        self.ops.append(op)
        self.program._bump_version()
        for vs in op.outputs.values():
            for name in vs:
                v = self._find_var_recursive(name)
                if v is not None:
                    v.op = op
        if infer_shape:
            from ..ops import registry
            registry.infer_shape(op, self)
        return op

    def _prepend_op(self, type=None, inputs=None, outputs=None, attrs=None):
        """An op at the head of the block, with no shape inference (the
        LR schedules' step counter)."""
        op = Operator(self, type=type, inputs=inputs, outputs=outputs,
                      attrs=attrs)
        self.ops.insert(0, op)
        self.program._bump_version()
        return op

    def _insert_op(self, index, type=None, inputs=None, outputs=None,
                   attrs=None):
        """An op at position `index`, with no shape inference (an error
        clip after the op that writes its grad)."""
        op = Operator(self, type=type, inputs=inputs, outputs=outputs,
                      attrs=attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def _serialize(self):
        return {
            "idx": self.idx, "parent_idx": self.parent_idx,
            "forward_block_idx": self.forward_block_idx,
            "vars": [v._serialize() for v in self.vars.values()],
            "ops": [op._serialize() for op in self.ops],
        }


class Program:
    """Whole-model IR: a list of Blocks.  The Executor consumes it
    directly."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._seed = 0
        self._op_uid = 0
        # the Executor's step-fn cache token: bumped wherever an op list
        # changes
        self._version = 0

    def _next_op_uid(self):
        self._op_uid += 1
        return self._op_uid

    def _bump_version(self):
        self._version += 1

    @property
    def random_seed(self):
        return self._seed

    @random_seed.setter
    def random_seed(self, seed):
        self._seed = int(seed)

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def block(self, idx):
        return self.blocks[idx]

    def _create_block(self, parent_idx=None):
        """A new block, child of the current one (or of `parent_idx`),
        made current: the control-flow layers build their sub-blocks
        here."""
        parent = self.current_block_idx if parent_idx is None \
            else parent_idx
        self.blocks.append(Block(self, len(self.blocks), parent))
        self.current_block_idx = len(self.blocks) - 1
        self._bump_version()
        return self.current_block()

    def _rollback(self):
        """Back to the current block's parent."""
        self.current_block_idx = self.current_block().parent_idx

    def all_parameters(self):
        return self.global_block().all_parameters()

    def clone(self, for_test=False):
        """A copy through the serialized form; `for_test` sets is_test on
        dropout and batch_norm."""
        p = Program.parse_from_string(self.serialize_to_string())
        if for_test:
            for blk in p.blocks:
                for op in blk.ops:
                    if op.type in _TEST_MODE_OPS:
                        op.attrs["is_test"] = True
        return p

    def _prune(self, feeds, fetches):
        """A clone holding only the ops that compute `fetches` from
        `feeds`, and the vars they touch (save_inference_model).  An op
        with a sub-block reads and writes what its block does (a
        conditional_block declares no outputs); the sub-blocks stay."""
        from .functionalizer import _op_tree_reads, _op_tree_writes
        p = self.clone()
        blk = p.global_block()
        feed_names = set(feeds)
        needed = set(fetches)
        keep = []
        for op in reversed(blk.ops):
            if _op_tree_writes(op) & needed:
                keep.append(op)
                needed.update(n for n in _op_tree_reads(op)
                              if n not in feed_names)
        keep.reverse()
        blk.ops = keep
        p._bump_version()
        used = set(feed_names) | set(fetches)
        for op in blk.ops:
            used |= _op_tree_reads(op) | _op_tree_writes(op)
        blk.vars = collections.OrderedDict(
            (k, v) for k, v in blk.vars.items() if k in used)
        return p

    def serialize_to_string(self):
        return json.dumps({
            "version": 1,
            "seed": self._seed,
            "blocks": [b._serialize() for b in self.blocks],
        })

    @staticmethod
    def parse_from_string(s):
        data = json.loads(s)
        p = Program()
        p._seed = data.get("seed", 0)
        p.blocks = []
        for bdata in data["blocks"]:
            blk = Block(p, bdata["idx"], bdata["parent_idx"])
            blk.forward_block_idx = bdata.get("forward_block_idx", -1)
            p.blocks.append(blk)

        def decode_attr(av):
            if isinstance(av, dict):
                if "__block__" in av:
                    return p.blocks[av["__block__"]]
                if "__ndarray__" in av:
                    return np.array(av["__ndarray__"], dtype=av["dtype"])
                return {k: decode_attr(x) for k, x in av.items()}
            if isinstance(av, list):
                return [decode_attr(x) for x in av]
            return av

        for blk, bdata in zip(p.blocks, data["blocks"]):
            for vd in bdata["vars"]:
                vd = dict(vd)
                cls = Parameter if vd.pop("is_parameter", False) else Variable
                trainable = vd.pop("trainable", None)
                v = cls(blk, **vd)
                if trainable is not None:
                    v.trainable = trainable
                blk.vars[v.name] = v
            for od in bdata["ops"]:
                attrs = {k: decode_attr(av) for k, av in od["attrs"].items()}
                op = Operator(blk, od["type"], od["inputs"], od["outputs"],
                              attrs)
                if "uid" in od:
                    op.uid = od["uid"]
                    p._op_uid = max(p._op_uid, op.uid)
                blk.ops.append(op)
        return p

    def to_string(self, throw_on_error=True, with_details=False):
        lines = []
        for blk in self.blocks:
            lines.append("-- block %d (parent %d) --" % (blk.idx,
                                                         blk.parent_idx))
            for v in blk.vars.values():
                lines.append("  " + repr(v))
            for op in blk.ops:
                lines.append("  " + repr(op))
        return "\n".join(lines)

    __str__ = to_string


# ops whose is_test attr clone(for_test=True) sets
_TEST_MODE_OPS = ("dropout", "batch_norm")

# ---- default programs & guards ----

_main_program_ = Program()
_startup_program_ = Program()


def default_startup_program():
    return _startup_program_


def default_main_program():
    return _main_program_


def switch_main_program(program):
    global _main_program_
    prev = _main_program_
    _main_program_ = program
    return prev


def switch_startup_program(program):
    global _startup_program_
    prev = _startup_program_
    _startup_program_ = program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)
