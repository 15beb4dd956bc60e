"""DataFeeder, after paddle_tpu/fluid/data_feeder.py: turns a batch of
reader samples (tuples in feed_list order) into a feed dict, a dense
array per lod_level-0 var and a LoDTensor per ragged (lod_level-1) var.
Nested (lod_level-2) feeds and the multi-device split are not ported."""

import numpy as np

from . import core
from .framework import Variable, default_main_program
from .lod import LoDTensor

__all__ = ["DataFeeder"]


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_dtypes = []
        self.feed_names = []
        self.feed_shapes = []
        self.feed_lod_level = []
        for each_var in feed_list:
            if isinstance(each_var, str):
                each_var = (program or default_main_program()
                            ).global_block().var(each_var)
            if not isinstance(each_var, Variable):
                raise TypeError("feed_list should be a list of Variable")
            if each_var.lod_level > 1:
                raise NotImplementedError(
                    "DataFeeder: %r has lod_level %d; nested LoD feeds are "
                    "not ported to paddle_tpu_torch yet (ROADMAP.md, queue "
                    "1 item 13)" % (each_var.name, each_var.lod_level))
            self.feed_names.append(each_var.name)
            self.feed_lod_level.append(each_var.lod_level)
            self.feed_shapes.append(each_var.shape)
            self.feed_dtypes.append(core.convert_dtype_to_np(each_var.dtype))
        self.place = place

    def feed(self, iterable):
        """iterable: the batch's samples, each a tuple in feed_list order.
        Returns {name: ndarray or LoDTensor}."""
        columns = list(zip(*iterable))
        ret = {}
        for name, dtype, shape, lod_level, col in zip(
                self.feed_names, self.feed_dtypes, self.feed_shapes,
                self.feed_lod_level, columns):
            if lod_level == 0:
                arr = np.asarray(col, dtype=dtype)
                if len(shape) and shape[-1] == 1 and arr.ndim == 1:
                    arr = arr.reshape(-1, 1)
                # restore the static trailing dims when the flat sample
                # size matches (a flat vector fed to a [C, H, W] layer)
                static = list(shape[1:])
                if (static and all(isinstance(d, int) and d > 0
                                   for d in static)
                        and arr.ndim >= 1
                        and tuple(arr.shape[1:]) != tuple(static)
                        and int(np.prod(arr.shape[1:])) ==
                        int(np.prod(static))):
                    arr = arr.reshape((-1,) + tuple(static))
                ret[name] = arr
            else:
                seq_lens = [len(s) for s in col]
                flat = np.concatenate(
                    [np.asarray(s, dtype=dtype).reshape(len(s), -1)
                     for s in col], axis=0)
                ret[name] = LoDTensor(flat)
                ret[name].set_recursive_sequence_lengths([seq_lens])
        return ret
