"""Data-input layers, after paddle_tpu/fluid/layers/io.py: `data` declares
a feed variable, dense or ragged (lod_level=1: fed as a LoDTensor); the
reader pipeline is not ported."""

from ..layer_helper import LayerHelper

__all__ = ["data"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         stop_gradient=True):
    if lod_level > 1:
        raise NotImplementedError(
            "data(lod_level=%d): nested LoD feeds (the @LOD_SEG companion) "
            "are not ported to paddle_tpu_torch yet (ROADMAP.md, queue 1 "
            "item 13)" % lod_level)
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.create_global_variable(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient, is_data=True)
