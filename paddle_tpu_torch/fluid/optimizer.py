"""Optimizers — program-rewriting, after paddle_tpu/fluid/optimizer.py:
`Optimizer.minimize` (append_backward, then regularization, then one
update op per parameter), `SGDOptimizer`, `MomentumOptimizer` and
`AdamOptimizer`.  Accumulators (velocities, moments, beta pows) and the
learning rate are persistable vars initialised in the startup program,
under the JAX package's names, so a scope carries across by name.
Gradient clipping and the other optimizers are not ported."""

from . import framework, unique_name
from . import regularizer as regularizer_mod
from .backward import append_backward
from .framework import Variable, default_main_program, \
    default_startup_program
from .initializer import Constant
from .layer_helper import LayerHelper

__all__ = ["SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer", "Adam",
           "AdamOptimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None):
        self.regularization = regularization
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        self._accumulators = {}  # name -> {param_name: var}

    # ---- learning rate ----
    def _create_global_learning_rate(self):
        program = default_main_program()
        if self._learning_rate_map.get(program) is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        if not isinstance(self._learning_rate, float):
            raise TypeError("learning rate must be float or Variable")
        from .layers import tensor
        lr = tensor.create_global_var(
            name=unique_name.generate("learning_rate"),
            shape=[1], value=float(self._learning_rate), dtype="float32",
            persistable=True)
        lr.stop_gradient = True
        self._learning_rate_map[program] = lr

    def _global_learning_rate(self, program=None):
        if program is None:
            program = default_main_program()
        return self._learning_rate_map.get(program)

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = getattr(param, "optimize_attr",
                           {"learning_rate": 1.0}).get("learning_rate", 1.0)
        base = self._global_learning_rate()
        if param_lr == 1.0:
            return base
        from .layers import nn
        return nn.scale(base, scale=float(param_lr))

    # ---- accumulators ----
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if name in self._accumulators and \
                param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        if shape is None:
            shape = param.shape
        helper = LayerHelper(name)
        var = helper.create_global_variable(
            name=unique_name.generate("%s_%s" % (param.name, name)),
            persistable=True, dtype=dtype or param.dtype, shape=shape,
            stop_gradient=True)
        helper.set_variable_initializer(var, Constant(float(fill_value)))
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block, parameters_and_grads):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # ---- the optimization pass ----
    def _create_optimization_pass(self, parameters_and_grads, loss,
                                  startup_program=None):
        program = loss.block.program
        global_block = program.global_block()
        with framework.program_guard(program, startup_program or
                                     default_startup_program()):
            self._create_global_learning_rate()
            self._create_accumulators(
                global_block, [p for p, g in parameters_and_grads
                               if g is not None])
            optimize_ops = []
            for param_and_grad in parameters_and_grads:
                if param_and_grad[1] is None:
                    continue
                if getattr(param_and_grad[0], "trainable", True):
                    optimize_ops.append(self._append_optimize_op(
                        global_block, param_and_grad))
            self._finish_update(global_block, parameters_and_grads)
        return optimize_ops

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        with framework.program_guard(loss.block.program, startup_program or
                                     default_startup_program()):
            return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        """Sorted by parameter name, then clipping, then regularization,
        in the JAX package's order."""
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        for p, _ in params_grads:
            if getattr(p, "gradient_clip_attr", None) is not None:
                raise NotImplementedError(
                    "gradient clipping (param %s) is not ported to "
                    "paddle_tpu_torch yet" % p.name)
        return regularizer_mod.append_regularization_ops(
            params_grads, self.regularization)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        with framework.program_guard(loss.block.program, startup_program or
                                     default_startup_program()):
            params_grads = self.apply_gradients(params_grads)
        optimize_ops = self._create_optimization_pass(
            params_grads, loss, startup_program)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type="sgd",
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0]}, infer_shape=False)


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = bool(use_nesterov)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity = self._get_accumulator(self._velocity_acc_str,
                                         param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "Velocity": velocity,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0],
                     "VelocityOut": velocity},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
            infer_shape=False)


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"
    _beta1_pow_acc_str = "beta1_pow_acc"
    _beta2_pow_acc_str = "beta2_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adam"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p,
                                  fill_value=self._beta1, shape=[1])
            self._add_accumulator(self._beta2_pow_acc_str, p,
                                  fill_value=self._beta2, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        moment1 = self._get_accumulator(self._moment1_acc_str, p)
        moment2 = self._get_accumulator(self._moment2_acc_str, p)
        beta1_pow = self._get_accumulator(self._beta1_pow_acc_str, p)
        beta2_pow = self._get_accumulator(self._beta2_pow_acc_str, p)
        return block.append_op(
            type=self.type,
            inputs={"Param": p, "Grad": param_and_grad[1],
                    "LearningRate": self._create_param_lr(param_and_grad),
                    "Moment1": moment1, "Moment2": moment2,
                    "Beta1Pow": beta1_pow, "Beta2Pow": beta2_pow},
            outputs={"ParamOut": p, "Moment1Out": moment1,
                     "Moment2Out": moment2},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
            infer_shape=False)

    def _finish_update(self, block, parameters_and_grads):
        """Update the beta pows with one scale op per param."""
        for param, grad in parameters_and_grads:
            if grad is None:
                continue
            for acc_name, beta in ((self._beta1_pow_acc_str, self._beta1),
                                   (self._beta2_pow_acc_str, self._beta2)):
                acc = self._get_accumulator(acc_name, param)
                block.append_op(
                    type="scale", inputs={"X": acc}, outputs={"Out": acc},
                    attrs={"scale": beta}, infer_shape=False)


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
