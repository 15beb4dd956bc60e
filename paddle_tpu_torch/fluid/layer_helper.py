"""LayerHelper — shared parameter/op plumbing for layer functions, a copy of
paddle_tpu/fluid/layer_helper.py."""

from . import unique_name
from .framework import default_main_program, default_startup_program, \
    Variable
from .param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = self.kwargs.get("name")
        if name is None:
            self.kwargs["name"] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, *args, **kwargs):
        op = self.main_program.current_block().append_op(*args, **kwargs)
        self._propagate_build_lod_level(kwargs)
        return op

    @staticmethod
    def _propagate_build_lod_level(kwargs):
        """The build-time side of the runtime companion propagation: a
        LoD-oblivious op's outputs inherit the largest input lod_level."""
        from .functionalizer import _LOD_DROP_OPS
        if kwargs.get("type") in _LOD_DROP_OPS:
            return
        level = 0
        for names in (kwargs.get("inputs") or {}).values():
            vs = names if isinstance(names, (list, tuple)) else [names]
            for v in vs:
                if isinstance(v, Variable):
                    level = max(level, v.lod_level or 0)
        if level:
            for names in (kwargs.get("outputs") or {}).values():
                vs = names if isinstance(names, (list, tuple)) else [names]
                for v in vs:
                    if isinstance(v, Variable) and not v.lod_level:
                        v.lod_level = level

    # ---- inputs ----
    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable):
            inputs = [inputs]
        return list(inputs)

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr", None))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr", None))

    def multiple_param_attr(self, length):
        attr = self.param_attr
        if isinstance(attr, ParamAttr):
            attr = [attr]
        if len(attr) != 1 and len(attr) != length:
            raise ValueError("parameter number mismatch")
        if len(attr) == 1 and length != 1:
            attr = [attr[0]] + [ParamAttr(**attr[0].__dict__.copy())
                                for _ in range(length - 1)]
        return attr

    def iter_inputs_and_params(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        param_attrs = self.multiple_param_attr(len(inputs))
        for ipt, param_attr in zip(inputs, param_attrs):
            yield ipt, param_attr

    def input_dtype(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for each in inputs:
            if dtype is None:
                dtype = each.dtype
            elif dtype != each.dtype:
                raise ValueError("Data Type mismatch: %d to %d" %
                                 (dtype, each.dtype))
        return dtype

    # ---- parameters ----
    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        if attr is False:
            return None
        attr = ParamAttr._to_attr(attr)
        if default_initializer is None:
            if is_bias:
                attr._set_default_bias_initializer()
            else:
                attr._set_default_param_initializer()
        else:
            attr._set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, "w" if
                                                       not is_bias else "b"]))
        startup_block = self.startup_program.global_block()
        if attr.name in startup_block.vars:
            # shared parameter (same explicit name created again): one
            # startup init, one runtime tensor
            existing = self.main_program.global_block().vars.get(attr.name)
            if existing is not None:
                return existing
        else:
            startup_p = startup_block.create_parameter(
                shape=shape, dtype=dtype, **attr._to_kwargs())
            attr.initializer(startup_p, startup_block)
        return self.main_program.global_block().create_parameter(
            shape=shape, dtype=dtype, **attr._to_kwargs())

    # ---- temp vars ----
    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, persistable=False, stop_gradient=stop_gradient)

    def create_variable(self, *args, **kwargs):
        return self.main_program.current_block().create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs)

    def set_variable_initializer(self, var, initializer):
        sb = self.startup_program.global_block()
        sv = sb.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                           persistable=True)
        initializer(sv, sb)

    # ---- bias / activation ----
    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.bias_attr
        if bias_attr is False:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        b = self.create_parameter(attr=bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act", None)
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp
