"""Data-input layers, after paddle_tpu/fluid/layers/io.py (reference
python/paddle/fluid/layers/io.py): `data` declares a feed variable,
dense, ragged (lod_level=1) or nested (lod_level=2), fed as a LoDTensor;
the reader layers build a `fluid.reader.PyReader` (a thread filling a
bounded queue, with the double buffer staging batches on the card)
whose feeds `exe.run(main, feed=feed)` takes:

    reader = fluid.layers.py_reader(capacity=4, shapes=[(-1, 13), (-1, 1)],
                                    dtypes=["float32", "float32"])
    x, y = fluid.layers.read_file(reader)
    ...
    reader.decorate_paddle_reader(batches)
    reader.start()
    for feed in reader:
        exe.run(main, feed=feed, fetch_list=[loss])
    reader.reset()

`open_files` reads RecordIO files of samples (fluid.recordio_writer),
`shuffle` and `batch` wrap a reader's provider, `Preprocessor` records
ops that transform a reader's vars inline in the main program, and
`load` appends an in-graph load op (ops/io_ops.py).
"""

import contextlib
import random

import numpy as np

from .. import unique_name
from ..layer_helper import LayerHelper

__all__ = ["data", "py_reader", "batch", "double_buffer", "read_file",
           "create_py_reader_by_data", "open_files", "shuffle",
           "random_data_generator", "Preprocessor", "load"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=None, stop_gradient=True):
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.create_global_variable(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient, is_data=True)


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """A PyReader with a data var per slot, named '<name>_slot_<i>' (the
    shapes lead with the batch axis); read_file gives its vars.  The
    double buffer stages on the card (double_buffer(reader, place) sets
    another place)."""
    from ..reader import PyReader
    vars_ = []
    for i, (shape, dtype) in enumerate(zip(shapes, dtypes)):
        vars_.append(data(name="%s_slot_%d" % (name or "py_reader", i),
                          shape=list(shape)[1:], dtype=dtype,
                          lod_level=lod_levels[i] if lod_levels else 0))
    return PyReader(capacity=capacity, feed_vars=vars_,
                    use_double_buffer=use_double_buffer)


def _wrap_provider(reader, wrap, what):
    inner = getattr(reader, "_paddle_reader", None)
    if inner is None:
        raise ValueError("%s() wraps readers made by py_reader, "
                         "create_py_reader_by_data or open_files with a "
                         "provider attached" % what)
    reader.decorate_tensor_provider(wrap(inner))
    return reader


def batch(reader, batch_size):
    """Group a reader's samples into batches of `batch_size` (each field
    stacked on a new leading axis; the last batch may be short).  A
    plain reader creator is batched as paddle.batch does."""
    if callable(reader) and not hasattr(reader, "_paddle_reader"):
        from ... import reader as rd
        return rd.batch(reader, batch_size)

    def wrap(inner):
        def batched():
            buf = []
            for item in inner():
                buf.append(item if isinstance(item, tuple) else (item,))
                if len(buf) == batch_size:
                    yield tuple(np.stack(f) for f in zip(*buf))
                    buf = []
            if buf:
                yield tuple(np.stack(f) for f in zip(*buf))
        return batched

    return _wrap_provider(reader, wrap, "batch")


def double_buffer(reader, place=None, name=None):
    """Turn the reader's double buffer on: its thread stages each batch
    on `place` (None: the card) while the current step runs."""
    reader.use_double_buffer = True
    reader.place = place
    return reader


def read_file(reader):
    return reader.output_vars


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    """A PyReader whose slots are existing data vars."""
    from ..reader import PyReader
    return PyReader(capacity=capacity, feed_vars=list(feed_list),
                    use_double_buffer=use_double_buffer)


def open_files(filenames, shapes, lod_levels, dtypes, thread_num=1,
               buffer_size=None, pass_num=1, is_test=None):
    """A reader over RecordIO files of samples (fluid.recordio_writer),
    `pass_num` passes over `filenames` in order, a sample a feed; its
    slots are new data vars.  No double buffer unless double_buffer()
    asks for one."""
    from ..recordio_writer import recordio_reader
    reader = py_reader(capacity=buffer_size or 64, shapes=shapes,
                       dtypes=dtypes, lod_levels=lod_levels,
                       name=unique_name.generate("open_files"),
                       use_double_buffer=False)
    if isinstance(filenames, str):
        filenames = [filenames]

    def gen():
        for _ in range(pass_num):
            for fn in filenames:
                for rec in recordio_reader(fn)():
                    yield rec if isinstance(rec, tuple) else (rec,)

    reader.decorate_tensor_provider(gen)
    return reader


def random_data_generator(low, high, shapes, lod_levels, for_parallel=True):
    """A reader of fp32 uniforms in [low, high) of the given shapes, for
    driving a network without a file (reference RandomDataGenerator);
    endless, each pass from a fresh unseeded RandomState, as the JAX
    package draws."""
    reader = py_reader(capacity=64,
                       shapes=[[-1] + list(s) for s in shapes],
                       dtypes=["float32"] * len(shapes),
                       lod_levels=lod_levels,
                       name=unique_name.generate("random_data_generator"),
                       use_double_buffer=False)

    def gen():
        rng = np.random.RandomState()
        while True:
            yield tuple(rng.uniform(low, high, size=tuple(s))
                        .astype(np.float32) for s in shapes)

    reader.decorate_tensor_provider(gen)
    return reader


class Preprocessor:
    """Ops recorded between `inputs()` and `outputs()` inside `block()`
    transform a reader's vars (reference create_custom_reader).  They
    stay inline in the main program; the returned reader exposes the
    transformed vars through read_file."""

    BEFORE_SUB_BLOCK = 0
    IN_SUB_BLOCK = 1
    AFTER_SUB_BLOCK = 2

    def __init__(self, reader, name=None):
        self.underlying_reader = reader
        self.status = Preprocessor.BEFORE_SUB_BLOCK
        self.source_var_names = None
        self.sink_var_names = None
        self._sink_vars = None

    def _is_completed(self):
        return self.source_var_names and self.sink_var_names

    @contextlib.contextmanager
    def block(self):
        self.status = Preprocessor.IN_SUB_BLOCK
        yield
        self.status = Preprocessor.AFTER_SUB_BLOCK
        if not self._is_completed():
            raise RuntimeError("Preprocessor definition incomplete: invoke "
                               "inputs() and outputs() inside the block")

    def inputs(self):
        if self.status != Preprocessor.IN_SUB_BLOCK:
            raise RuntimeError(
                "Preprocessor.inputs() can only be invoked inside block()")
        src = list(self.underlying_reader.output_vars)
        self.source_var_names = [v.name for v in src]
        return src

    def outputs(self, *outs):
        if self.status != Preprocessor.IN_SUB_BLOCK:
            raise RuntimeError(
                "Preprocessor.outputs() can only be invoked inside block()")
        self.sink_var_names = [o.name for o in outs]
        self._sink_vars = list(outs)

    def __call__(self, *args, **kwargs):
        if self.status != Preprocessor.AFTER_SUB_BLOCK:
            raise RuntimeError(
                "Preprocessor output is only available after block()")
        self.underlying_reader.output_vars = list(self._sink_vars)
        return self.underlying_reader


def load(out, file_path, load_as_fp16=None):
    """Load a tensor saved by the save op (or numpy.save) into `out`."""
    helper = LayerHelper("load")
    attrs = {"file_path": file_path}
    if load_as_fp16 is not None:
        attrs["load_as_fp16"] = load_as_fp16
    helper.append_op(type="load", inputs={}, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def shuffle(reader, buffer_size):
    """Shuffle a reader's samples within windows of `buffer_size`
    (Python's global random state)."""

    def wrap(inner):
        def shuffled():
            buf = []
            for item in inner():
                buf.append(item)
                if len(buf) >= buffer_size:
                    random.shuffle(buf)
                    yield from buf
                    buf = []
            random.shuffle(buf)
            yield from buf
        return shuffled

    return _wrap_provider(reader, wrap, "shuffle")
