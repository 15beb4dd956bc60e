"""L1 / L2 weight decay appended as ops, a copy of
paddle_tpu/fluid/regularizer.py: the decay term is a `scale` (L2) or a
`sign` then a `scale` (L1) of the parameter, added to its grad by a
`sum`, under the JAX package's var names."""

from .layer_helper import LayerHelper

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l2_decay")
        decay = helper.create_variable_for_type_inference(param.dtype)
        block.append_op(type="scale", inputs={"X": param},
                        outputs={"Out": decay},
                        attrs={"scale": self._regularization_coeff},
                        infer_shape=False)
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(param.dtype)
        decay = helper.create_variable_for_type_inference(param.dtype)
        block.append_op(type="sign", inputs={"X": param},
                        outputs={"Out": sign}, infer_shape=False)
        block.append_op(type="scale", inputs={"X": sign},
                        outputs={"Out": decay},
                        attrs={"scale": self._regularization_coeff},
                        infer_shape=False)
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """grad + decay for every parameter with a regularizer: its own
    (`param.regularizer`) before the optimizer's."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        if grad is None:
            params_and_grads.append((param, grad))
            continue
        reg = getattr(param, "regularizer", None) or regularization
        if reg is None:
            params_and_grads.append((param, grad))
            continue
        term = reg(param, grad, grad.block)
        helper = LayerHelper("regularized")
        new_grad = helper.create_variable_for_type_inference(param.dtype)
        grad.block.append_op(
            type="sum", inputs={"X": [grad, term]},
            outputs={"Out": new_grad}, infer_shape=False)
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
