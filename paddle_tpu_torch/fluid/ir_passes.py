"""Program-level passes, after paddle_tpu/fluid/ir_passes.py: the Pass
registry, `apply_passes`, `GraphPatternDetector` (declarative op chains
with single-consumer constraints) and FuseBottleneckPass.  A pass works
on the Program in place (the Program is the graph: ops plus var
def/use edges).  The JAX file's other passes (graph_viz, is_test,
fuse_elewise_add_act, fc_fuse, multi_batch_merge, fc_lstm_fuse) are not
ported yet."""

from .framework import Operator

__all__ = ["Pass", "register_pass", "get_pass", "apply_passes",
           "use_count", "GraphPatternDetector", "FuseBottleneckPass"]

_PASS_REGISTRY = {}


class Pass:
    """Subclasses implement apply_impl(program)."""

    name = None

    def __init__(self, **attrs):
        self.attrs = dict(attrs)

    def apply(self, program):
        out = self.apply_impl(program)
        return out if out is not None else program

    def apply_impl(self, program):
        raise NotImplementedError


def register_pass(cls):
    if not cls.name:
        raise ValueError("pass %s needs a name" % cls.__name__)
    _PASS_REGISTRY[cls.name] = cls
    return cls


def get_pass(name, **attrs):
    return _PASS_REGISTRY[name](**attrs)


def apply_passes(program, names, **attrs):
    for n in names:
        program = get_pass(n, **attrs).apply(program)
    return program


def use_count(block, var_name, _seen=None):
    """Number of op inputs in `block` reading var_name, reads inside
    nested sub-blocks included (a fusion must not delete an op whose
    output another op still reads)."""
    _seen = _seen if _seen is not None else set()
    n_uses = 0
    for o in block.ops:
        n_uses += sum(1 for ns in o.inputs.values() for n in ns
                      if n == var_name)
        sub = o.attrs.get("sub_block")
        if sub is not None and id(sub) not in _seen:
            _seen.add(id(sub))
            n_uses += use_count(sub, var_name, _seen)
    return n_uses


class GraphPatternDetector:
    """Declarative subgraph patterns over a Block.

    Usage:
        d = GraphPatternDetector()
        d.add_op("mul", types=["mul"], outputs={"Out": "mm"})
        d.add_op("add", types=["elementwise_add"], inputs={"X": "mm"},
                 single_use={"mm"})
        for m in d.detect(block):   # m: name -> Operator
            ...rewrite...

    Symbols (like "mm") bind to concrete var names; a symbol appearing in
    one node's outputs and another's inputs is a dataflow edge. `single_use`
    marks symbols that must have exactly one consumer in the block (the
    reference's intermediate-node constraint, so fusion never drops a value
    some other op still reads).
    """

    def __init__(self):
        self._nodes = []   # (name, types, in_links, out_links, single_use)

    def add_op(self, name, types, inputs=None, outputs=None,
               single_use=()):
        self._nodes.append((name, tuple(types), dict(inputs or {}),
                            dict(outputs or {}), frozenset(single_use)))
        return self

    def detect(self, block):
        """Yield non-overlapping matches as {node_name: Operator}."""
        matches = []
        used_ops = set()

        def bind(node_idx, binding, chosen, anchor=None):
            if node_idx == len(self._nodes):
                matches.append(dict(chosen))
                used_ops.update(id(op) for op in chosen.values())
                return True
            name, types, ins, outs, single = self._nodes[node_idx]
            for op in ([anchor] if anchor is not None else block.ops):
                if op.type not in types or id(op) in used_ops or \
                        any(op is c for c in chosen.values()):
                    continue
                b2 = dict(binding)
                ok = True
                for slot, sym in ins.items():
                    actual = op.inputs.get(slot, [None])[0]
                    if actual is None or \
                            (sym in b2 and b2[sym] != actual):
                        ok = False
                        break
                    b2[sym] = actual
                if not ok:
                    continue
                for slot, sym in outs.items():
                    actual = op.outputs.get(slot, [None])[0]
                    if actual is None or \
                            (sym in b2 and b2[sym] != actual):
                        ok = False
                        break
                    b2[sym] = actual
                if not ok:
                    continue
                if any(use_count(block, b2[s]) != 1 for s in single
                       if s in b2):
                    continue
                chosen[name] = op
                if bind(node_idx + 1, b2, chosen):
                    return True
                del chosen[name]
            return False

        # greedily find all non-overlapping matches: each op is tried as
        # the first pattern node's anchor exactly once (no full-search
        # restart per accepted match)
        for op in list(block.ops):
            if id(op) not in used_ops:
                bind(0, {}, {}, anchor=op)
        return matches


@register_pass
class FuseBottleneckPass(Pass):
    """Collapse a BN-folded ResNet bottleneck (conv1x1+bias+relu ->
    conv3x3+bias+relu -> conv1x1+bias -> add(shortcut) -> relu, NHWC) into
    one `fused_bottleneck` op, which runs K6 (ops/pallas_kernels.py,
    csrc/fused_bottleneck.cu) on the card.  Runs after the
    InferenceTranspiler's BN fold, which produces exactly this op chain.
    NHWC only; NCHW programs are left as they are.  The width gate, the
    channel-bias check and the rewrite order are the JAX pass's, so both
    packages fuse the same blocks into the same program."""

    name = "fuse_bottleneck_pass"

    @staticmethod
    def _norm2(v, default):
        if v is None:
            return (default, default)
        if isinstance(v, (list, tuple)):
            return (int(v[0]), int(v[1] if len(v) > 1 else v[0]))
        return (int(v), int(v))

    def _conv_geom(self, blk, op, ksize, stride=None, padding=0):
        """conv2d op is a plain kxk NHWC conv with the given geometry."""
        if op.attrs.get("data_format", "NCHW") != "NHWC":
            return None
        if op.inputs.get("Bias"):
            # the fused op has no slot for an inline conv bias (B0/B1/B2
            # come from the BN-fold elementwise_adds); rewriting would
            # drop it and change numerics
            return None
        if int(op.attrs.get("groups", 1) or 1) != 1:
            return None
        if self._norm2(op.attrs.get("dilations"), 1) != (1, 1):
            return None
        if self._norm2(op.attrs.get("paddings"), 0) != (padding, padding):
            return None
        st = self._norm2(op.attrs.get("strides"), 1)
        if st[0] != st[1] or (stride is not None and st != (stride, stride)):
            return None
        w = blk._find_var_recursive(op.inputs["Filter"][0])
        if w is None or w.shape is None or tuple(w.shape[2:]) != (ksize,
                                                                  ksize):
            return None
        return st[0]

    @staticmethod
    def _is_channel_bias(blk, op, channels):
        """elementwise_add whose Y is a persistable per-channel vector of
        the conv's output width, broadcast over the trailing (NHWC
        channel) axis — the exact shape the BN fold emits. A vector
        riding a different axis (or length) is some other computation."""
        if op.attrs.get("axis", -1) not in (-1, 3):
            return False
        v = blk._find_var_recursive(op.inputs["Y"][0])
        if v is None or v.shape is None:
            return False
        dims = [d for d in v.shape if d != 1]
        return (len(dims) <= 1 and getattr(v, "persistable", False)
                and (not dims or dims[0] == channels))

    def _filter_shape(self, blk, op):
        w = blk._find_var_recursive(op.inputs["Filter"][0])
        return None if w is None else tuple(w.shape or ())

    def _detector(self, branch, swapped):
        d = GraphPatternDetector()
        d.add_op("conv0", types=["conv2d"], inputs={"Input": "xin"},
                 outputs={"Output": "c0"})
        d.add_op("add0", types=["elementwise_add"], inputs={"X": "c0"},
                 outputs={"Out": "a0"}, single_use={"c0"})
        d.add_op("relu0", types=["relu"], inputs={"X": "a0"},
                 outputs={"Out": "r0"}, single_use={"a0"})
        d.add_op("conv1", types=["conv2d"], inputs={"Input": "r0"},
                 outputs={"Output": "c1"}, single_use={"r0"})
        d.add_op("add1", types=["elementwise_add"], inputs={"X": "c1"},
                 outputs={"Out": "a1"}, single_use={"c1"})
        d.add_op("relu1", types=["relu"], inputs={"X": "a1"},
                 outputs={"Out": "r1"}, single_use={"a1"})
        d.add_op("conv2", types=["conv2d"], inputs={"Input": "r1"},
                 outputs={"Output": "c2"}, single_use={"r1"})
        d.add_op("add2", types=["elementwise_add"], inputs={"X": "c2"},
                 outputs={"Out": "a2"}, single_use={"c2"})
        if branch:
            d.add_op("convs", types=["conv2d"], inputs={"Input": "xin"},
                     outputs={"Output": "cs"})
            d.add_op("adds", types=["elementwise_add"], inputs={"X": "cs"},
                     outputs={"Out": "short"}, single_use={"cs"})
            res_in = {"X": "short", "Y": "a2"} if not swapped else \
                     {"X": "a2", "Y": "short"}
            single = {"a2", "short"}
        else:
            res_in = {"X": "xin", "Y": "a2"} if not swapped else \
                     {"X": "a2", "Y": "xin"}
            single = {"a2"}
        d.add_op("add_res", types=["elementwise_add"], inputs=res_in,
                 outputs={"Out": "res"}, single_use=single)
        d.add_op("relu_f", types=["relu"], inputs={"X": "res"},
                 outputs={"Out": "out"}, single_use={"res"})
        return d

    def _try_rewrite(self, blk, m, branch):
        s = self._conv_geom(blk, m["conv1"], 3, padding=1)
        if s is None or s not in (1, 2):
            return False
        if self._conv_geom(blk, m["conv0"], 1, stride=1) is None:
            return False
        if self._conv_geom(blk, m["conv2"], 1, stride=1) is None:
            return False
        if branch and self._conv_geom(blk, m["convs"], 1, stride=s) is None:
            return False
        # the kernel needs a consistent OIHW filter chain with a SQUARE
        # 3x3 (C->F->F->C4): a width-changing middle conv is a valid
        # graph but not this kernel's shape
        f0 = self._filter_shape(blk, m["conv0"])   # [F, C, 1, 1]
        f1 = self._filter_shape(blk, m["conv1"])   # [F, F, 3, 3]
        f2 = self._filter_shape(blk, m["conv2"])   # [C4, F, 1, 1]
        if not (f0 and f1 and f2):
            return False
        F, C = f0[0], f0[1]
        if f1[:2] != (F, F) or f2[1] != F:
            return False
        # the width gate: only blocks with F <= the flag fuse (0, the
        # default, fuses none)
        from ..flags import FLAGS
        if F > FLAGS.fuse_bottleneck_max_width:
            return False
        C4 = f2[0]
        if branch:
            fs = self._filter_shape(blk, m["convs"])
            if not fs or fs[:2] != (C4, C):
                return False
        elif C != C4 or s != 1:
            return False
        widths = {"add0": F, "add1": F, "add2": C4, "adds": C4}
        for a in ("add0", "add1", "add2") + (("adds",) if branch else ()):
            if not self._is_channel_bias(blk, m[a], widths[a]):
                return False
        inputs = {"X": list(m["conv0"].inputs["Input"]),
                  "W0": list(m["conv0"].inputs["Filter"]),
                  "B0": list(m["add0"].inputs["Y"]),
                  "W1": list(m["conv1"].inputs["Filter"]),
                  "B1": list(m["add1"].inputs["Y"]),
                  "W2": list(m["conv2"].inputs["Filter"]),
                  "B2": list(m["add2"].inputs["Y"])}
        if branch:
            inputs["Ws"] = list(m["convs"].inputs["Filter"])
            inputs["Bs"] = list(m["adds"].inputs["Y"])
        fused = Operator(blk, "fused_bottleneck", inputs=inputs,
                         outputs={"Out": list(m["relu_f"].outputs["Out"])},
                         attrs={"stride": s, "data_format": "NHWC"})
        first = min(blk.ops.index(op) for op in m.values())
        for op in m.values():
            blk.ops.remove(op)
        blk.ops.insert(first, fused)
        blk.program._bump_version()
        return True

    def apply_impl(self, program):
        blk = program.global_block()
        # projection-shortcut blocks first (their identity-pattern prefix
        # would otherwise shadow), then identity; both add orderings
        for branch in (True, False):
            for swapped in (False, True):
                for m in self._detector(branch, swapped).detect(blk):
                    self._try_rewrite(blk, m, branch)
        return program
