"""Inference-time rewrites, after
paddle_tpu/fluid/transpiler/inference_transpiler.py: dropout becomes a
scale op, batch norm folds into the conv before it (the scope's filter is
rewritten in place and a `<filter>@bn_folded_bias` var carries the shift),
FuseBottleneckPass collapses NHWC bottleneck blocks, and is_test is set
on what remains."""

import torch

from ..framework import Operator

__all__ = ["InferenceTranspiler"]


class InferenceTranspiler:
    def transpile(self, program, place=None, scope=None):
        """Apply the inference rewrites to `program` in place, reading
        and rewriting weights in `scope` (the global scope by default)."""
        if scope is None:
            from ..executor import global_scope
            scope = global_scope()
        self._remove_dropout(program)
        self._fuse_batch_norm(program, scope)
        from ..ir_passes import apply_passes
        apply_passes(program, ["fuse_bottleneck_pass"])
        self._set_is_test(program)
        return program

    def _set_is_test(self, program):
        for block in program.blocks:
            for op in block.ops:
                if op.type in ("dropout", "batch_norm", "lrn"):
                    op.attrs["is_test"] = True

    def _remove_dropout(self, program):
        """dropout at inference is the identity (upscale_in_train) or a
        fixed scale: a scale op keeps the downstream names."""
        for block in program.blocks:
            new_ops = []
            for op in block.ops:
                if op.type != "dropout":
                    new_ops.append(op)
                    continue
                impl = op.attrs.get("dropout_implementation",
                                    "downgrade_in_infer")
                scale = 1.0 if impl == "upscale_in_train" else \
                    1.0 - float(op.attrs.get("dropout_prob", 0.5))
                new_ops.append(Operator(
                    block, "scale", inputs={"X": op.input("X")},
                    outputs={"Out": op.output("Out")},
                    attrs={"scale": scale, "bias": 0.0,
                           "bias_after_scale": True}))
            block.ops = new_ops
            program._bump_version()

    def _fuse_batch_norm(self, program, scope):
        """conv2d -> batch_norm, where the conv's output feeds only the
        batch norm, becomes conv2d with W' = W * gamma / sqrt(var + eps)
        per output channel, then elementwise_add of b' = (b - mean) *
        gamma / sqrt(var + eps) + beta."""
        for block in program.blocks:
            producers = {}
            for op in block.ops:
                for name in op.output_arg_names:
                    producers[name] = op
            old_ops = list(block.ops)
            result = []
            for op in old_ops:
                if op.type == "batch_norm":
                    x = op.input("X")[0]
                    prev = producers.get(x)
                    if prev is not None and prev.type == "conv2d" and \
                            self._only_consumer(old_ops, x):
                        replacement = self._fold(block, scope, prev, op)
                        if replacement is not None:
                            result.append(replacement)
                            continue
                result.append(op)
            block.ops = result
            program._bump_version()

    @staticmethod
    def _only_consumer(ops, name):
        return sum(1 for op in ops if name in op.input_arg_names) == 1

    def _fold(self, block, scope, conv_op, bn_op):
        w_name = conv_op.input("Filter")[0]
        w = scope.get(w_name)
        scale = scope.get(bn_op.input("Scale")[0])
        bias = scope.get(bn_op.input("Bias")[0])
        mean = scope.get(bn_op.input("Mean")[0])
        var = scope.get(bn_op.input("Variance")[0])
        if any(v is None for v in (w, scale, bias, mean, var)):
            return None
        conv_bias = None
        if conv_op.inputs.get("Bias"):
            # BN(conv + b) = inv_std * conv + (beta + (b - mean) * inv_std):
            # the inline bias folds into the new add and leaves the conv;
            # without its value the fold would change numerics
            conv_bias = scope.get(conv_op.input("Bias")[0])
            if conv_bias is None:
                return None
        eps = float(bn_op.attrs.get("epsilon", 1e-5))
        inv_std = scale / torch.sqrt(var + eps)
        # OIHW filter: fold per output channel O
        scope.set(w_name, w * inv_std.reshape(-1, 1, 1, 1))
        shift = mean if conv_bias is None else mean - conv_bias.reshape(-1)
        new_bias = bias - shift * inv_std
        if conv_bias is not None:
            conv_op.inputs.pop("Bias", None)
        bias_name = w_name + "@bn_folded_bias"
        block.create_var(name=bias_name, shape=tuple(new_bias.shape),
                         dtype="float32", persistable=True)
        scope.set(bias_name, new_bias)
        # the per-channel add broadcasts over the conv's channel axis:
        # 1 for NCHW, the trailing one for NHWC
        axis = 1 if conv_op.attrs.get("data_format", "NCHW") == "NCHW" \
            else -1
        return Operator(
            block, "elementwise_add",
            inputs={"X": [conv_op.output("Output")[0]],
                    "Y": [bias_name]},
            outputs={"Out": [bn_op.output("Y")[0]]},
            attrs={"axis": axis})
