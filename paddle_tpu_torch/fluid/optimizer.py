"""Optimizers — program-rewriting, after paddle_tpu/fluid/optimizer.py:
`Optimizer.minimize` (append_backward, then gradient clipping, then
regularization, then one update op per parameter), SGD, Momentum,
LarsMomentum, Adagrad, Adam, Adamax, DecayedAdagrad, Adadelta, RMSProp,
Ftrl and ModelAverage.  Accumulators (velocities, moments, beta pows,
ModelAverage's sums) and the learning rate are persistable vars
initialised in the startup program, under the JAX package's names, so a
scope carries across by name."""

from . import clip as clip_mod
from . import framework, unique_name
from . import regularizer as regularizer_mod
from .backward import append_backward
from .framework import Variable, default_main_program, \
    default_startup_program
from .initializer import Constant
from .layer_helper import LayerHelper

__all__ = [
    "SGD", "Momentum", "Adagrad", "Adam", "Adamax", "DecayedAdagrad",
    "Ftrl", "SGDOptimizer", "MomentumOptimizer", "AdagradOptimizer",
    "AdamOptimizer", "AdamaxOptimizer", "DecayedAdagradOptimizer",
    "RMSPropOptimizer", "FtrlOptimizer", "Adadelta", "AdadeltaOptimizer",
    "ModelAverage", "LarsMomentum", "LarsMomentumOptimizer",
]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._name = name
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
                 no_grad_set=None, callbacks=None):
        with framework.program_guard(loss.block.program, startup_program or
                                     default_startup_program()):
            return append_backward(loss, parameter_list, no_grad_set,
                                   callbacks)

    def apply_gradients(self, params_grads):
        """Sorted by parameter name, then clipping, then regularization,
        in the JAX package's order."""
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        params_grads = clip_mod.append_gradient_clip_ops(params_grads)
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


class LarsMomentumOptimizer(MomentumOptimizer):
    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kwargs):
        super().__init__(learning_rate, momentum, **kwargs)
        self.type = "lars_momentum"
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

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
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay},
            infer_shape=False)


class AdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adagrad"
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str,
                                       param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "Moment": moment,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0], "MomentOut": moment},
            attrs={"epsilon": self._epsilon}, infer_shape=False)


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"
    _beta1_pow_acc_str = "beta1_pow_acc"
    _beta2_pow_acc_str = "beta2_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        # lazy_mode is taken as the JAX package takes it: a sparse grad's
        # update is always lazy (only the touched rows move), a dense
        # one never
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


class AdamaxOptimizer(Optimizer):
    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"
    _beta1_pow_acc_str = "beta1_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adamax"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p,
                                  fill_value=self._beta1, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        moment = self._get_accumulator(self._moment_acc_str, p)
        inf_norm = self._get_accumulator(self._inf_norm_acc_str, p)
        beta1_pow = self._get_accumulator(self._beta1_pow_acc_str, p)
        return block.append_op(
            type=self.type,
            inputs={"Param": p, "Grad": param_and_grad[1],
                    "LearningRate": self._create_param_lr(param_and_grad),
                    "Moment": moment, "InfNorm": inf_norm,
                    "Beta1Pow": beta1_pow},
            outputs={"ParamOut": p, "MomentOut": moment,
                     "InfNormOut": inf_norm},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
            infer_shape=False)

    def _finish_update(self, block, parameters_and_grads):
        for param, grad in parameters_and_grads:
            if grad is None:
                continue
            acc = self._get_accumulator(self._beta1_pow_acc_str, param)
            block.append_op(type="scale", inputs={"X": acc},
                            outputs={"Out": acc},
                            attrs={"scale": self._beta1}, infer_shape=False)


class DecayedAdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "decayed_adagrad"
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str,
                                       param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "Moment": moment,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0], "MomentOut": moment},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
            infer_shape=False)


class AdadeltaOptimizer(Optimizer):
    """Takes no LearningRate input, as the JAX op (and adadelta_op.cc)."""
    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adadelta"
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        g_acc = self._get_accumulator(self._avg_squared_grad_acc_str,
                                      param_and_grad[0])
        u_acc = self._get_accumulator(self._avg_squared_update_acc_str,
                                      param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "AvgSquaredGrad": g_acc, "AvgSquaredUpdate": u_acc},
            outputs={"ParamOut": param_and_grad[0],
                     "AvgSquaredGradOut": g_acc,
                     "AvgSquaredUpdateOut": u_acc},
            attrs={"epsilon": self._epsilon, "rho": self._rho},
            infer_shape=False)


class RMSPropOptimizer(Optimizer):
    _momentum_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"
    _mean_grad_acc_str = "mean_grad"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "rmsprop"
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)
            self._add_accumulator(self._mean_grad_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        momentum = self._get_accumulator(self._momentum_acc_str, p)
        mean_square = self._get_accumulator(self._mean_square_acc_str, p)
        mean_grad = self._get_accumulator(self._mean_grad_acc_str, p)
        return block.append_op(
            type=self.type,
            inputs={"Param": p, "Grad": param_and_grad[1],
                    "Moment": momentum, "MeanSquare": mean_square,
                    "MeanGrad": mean_grad,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "MomentOut": momentum,
                     "MeanSquareOut": mean_square,
                     "MeanGradOut": mean_grad},
            attrs={"epsilon": self._epsilon, "decay": self._rho,
                   "momentum": self._momentum, "centered": self._centered},
            infer_shape=False)


class FtrlOptimizer(Optimizer):
    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "ftrl"
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        squared = self._get_accumulator(self._squared_acc_str, p)
        linear = self._get_accumulator(self._linear_acc_str, p)
        return block.append_op(
            type=self.type,
            inputs={"Param": p, "Grad": param_and_grad[1],
                    "SquaredAccumulator": squared,
                    "LinearAccumulator": linear,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "SquaredAccumOut": squared,
                     "LinearAccumOut": linear},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power},
            infer_shape=False)


class ModelAverage(Optimizer):
    """A sliding-window average of the parameters, for evaluation.  Built
    after `minimize`, it appends one `average_accumulates` op a parameter
    to the default main program (the window's sum_1/sum_2/sum_3 buffers
    and its counters, ops/optimizer_ops.py).  `apply()` is a context
    manager that puts (sum_1 + sum_2 + sum_3) / (num + old_num) into the
    global scope in place of each parameter, and `restore()` (called on
    leaving it, unless need_restore is False) puts the trained values
    back."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        super().__init__(learning_rate=0.0, **kwargs)
        self.average_window = float(average_window_rate)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        self.params = [
            p for p in
            default_main_program().global_block().all_parameters()
            if getattr(p, "do_model_average", None) is not False]
        self._backup = {}
        for p in self.params:
            self._append_average_accumulate_op(p)

    def _append_average_accumulate_op(self, param):
        s1 = self._add_accumulator("sum_1", param)
        s2 = self._add_accumulator("sum_2", param)
        s3 = self._add_accumulator("sum_3", param)
        num_acc = self._add_accumulator("num_accumulates", param,
                                        dtype="int64", shape=[1])
        old_num = self._add_accumulator("old_num_accumulates", param,
                                        dtype="int64", shape=[1])
        num_upd = self._add_accumulator("num_updates", param,
                                        dtype="int64", shape=[1])
        default_main_program().global_block().append_op(
            type="average_accumulates",
            inputs={"param": param, "in_sum_1": s1, "in_sum_2": s2,
                    "in_sum_3": s3, "in_num_accumulates": num_acc,
                    "in_old_num_accumulates": old_num,
                    "in_num_updates": num_upd},
            outputs={"out_sum_1": s1, "out_sum_2": s2, "out_sum_3": s3,
                     "out_num_accumulates": num_acc,
                     "out_old_num_accumulates": old_num,
                     "out_num_updates": num_upd},
            attrs={"average_window": self.average_window,
                   "min_average_window": self.min_average_window,
                   "max_average_window": self.max_average_window},
            infer_shape=False)

    def _averaged_value(self, scope, param):
        acc = lambda name: scope.get(self._get_accumulator(name,
                                                           param).name)
        n = int(acc("num_accumulates").reshape(())) + \
            int(acc("old_num_accumulates").reshape(()))
        if n == 0:
            raise RuntimeError(
                "ModelAverage.apply() before any training step: the "
                "window is empty (run the main program at least once so "
                "average_accumulates sees an update)")
        return (acc("sum_1") + acc("sum_2") + acc("sum_3")) / n

    def apply(self, executor=None, need_restore=True):
        """Context manager: averaged params in, trained params back out."""
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            from .executor import global_scope
            scope = global_scope()
            for p in self.params:
                trained = scope.get(p.name)
                self._backup[p.name] = trained
                scope.set(p.name, self._averaged_value(scope, p)
                          .to(trained.dtype))
            try:
                yield
            finally:
                if need_restore:
                    self.restore(executor)
        return _ctx()

    def restore(self, executor=None):
        from .executor import global_scope
        scope = global_scope()
        for p in self.params:
            if p.name in self._backup:
                scope.set(p.name, self._backup.pop(p.name))


# fluid's short aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer
