"""LoD (Level-of-Detail) ragged-sequence tensors, a copy of
paddle_tpu/fluid/lod.py.

A `LoDTensor` is a packed host array (the rows of every sequence
concatenated along axis 0) plus its LoD offsets, numpy on the host as in
the JAX package.  The Executor turns one into a padded [B, T, ...]
tensor on its device plus a `<name>@LOD_LEN` int32 [B] lengths
companion (`pad_lod_feed`, T bucketed to a power of two of at least 16),
and a ragged fetch back into a packed LoDTensor
(`unpad_to_lod_tensor`).  A 2-level (nested) LoDTensor pads its INNER
sequences the same way and adds a `<name>@LOD_SEG` int32 [B_outer]
companion, the count of inner sequences in each outer group.
Lowerings read the companions through `ExecContext.lod_len` and
`ExecContext.lod_seg` (ops/registry.py).
"""

import numpy as np

__all__ = ["LoDTensor", "create_lod_tensor", "create_random_int_lodtensor",
           "recursive_seq_lens_to_lod", "lod_to_recursive_seq_lens",
           "pad_lod_feed", "unpad_to_lod_tensor",
           "nested_samples_to_lod_tensor"]


def recursive_seq_lens_to_lod(recursive_seq_lens):
    """[[2,3],[1,2,1,2,2]] -> offsets [[0,2,5],[0,1,3,4,6,8]]"""
    lod = []
    for lens in recursive_seq_lens:
        offsets = [0]
        for n in lens:
            offsets.append(offsets[-1] + n)
        lod.append(offsets)
    return lod


def lod_to_recursive_seq_lens(lod):
    return [[offsets[i + 1] - offsets[i] for i in range(len(offsets) - 1)]
            for offsets in lod]


class LoDTensor:
    """Dense host ndarray + LoD offsets, with the pybind LoDTensor's
    methods (set, lod, recursive_sequence_lengths, shape, numpy)."""

    def __init__(self, data=None, lod=None):
        self._data = np.asarray(data) if data is not None else None
        self._lod = lod or []

    def set(self, data, place=None):
        self._data = np.asarray(data)

    def set_lod(self, lod):
        self._lod = [list(level) for level in lod]

    def lod(self):
        return self._lod

    def set_recursive_sequence_lengths(self, seq_lens):
        self._lod = recursive_seq_lens_to_lod(seq_lens)

    def recursive_sequence_lengths(self):
        return lod_to_recursive_seq_lens(self._lod)

    def has_valid_recursive_sequence_lengths(self):
        if not self._lod:
            return True
        rows = self._data.shape[0] if self._data is not None else 0
        return self._lod[-1][-1] == rows

    def shape(self):
        return list(self._data.shape)

    def numpy(self):
        return self._data

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._data, dtype=dtype)

    def __repr__(self):
        return "LoDTensor(shape=%s, lod=%s)" % (
            None if self._data is None else self._data.shape, self._lod)


def _bucket_len(n, minimum=16):
    """The next power of two >= n, at least `minimum`: a few padded
    lengths cover every batch's raggedness."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_lod_feed(lod_tensor, bucket=True):
    """A packed LoDTensor -> (padded [B, T, ...], lengths int32 [B], seg).
    T is bucketed to a power of two (at least 16).  For a 2-level LoD, B
    counts the INNER sequences and `seg` is the int32 [B_outer] count of
    inner sequences per outer group; None for a single-level input.
    Raises ValueError on an invalid LoD, the reference's CheckLoD: every
    level starts at 0 and is monotone, level i ends at level i+1's
    sequence count, and the last level ends at the row count (a lengths
    list passed as offsets fails here)."""
    data = np.asarray(lod_tensor)
    lod = lod_tensor.lod()
    for li, level in enumerate(lod):
        level = list(level)
        end = (data.shape[0] if li == len(lod) - 1
               else len(lod[li + 1]) - 1)
        if (len(level) == 0 or level[0] != 0 or level[-1] != end
                or any(level[i] > level[i + 1]
                       for i in range(len(level) - 1))):
            raise ValueError(
                "invalid LoD level %d %r (expected offsets 0..%d): "
                "lod() carries OFFSETS, not lengths (use "
                "set_recursive_sequence_lengths for lengths)"
                % (li, lod, end))
    offsets = lod[-1]
    lens = np.array([offsets[i + 1] - offsets[i]
                     for i in range(len(offsets) - 1)], dtype=np.int32)
    B = len(lens)
    T = int(lens.max()) if B else 0
    if bucket:
        T = _bucket_len(max(T, 1))
    padded = np.zeros((B, T) + data.shape[1:], dtype=data.dtype)
    for i in range(B):
        padded[i, :lens[i]] = data[offsets[i]:offsets[i + 1]]
    seg = None
    if len(lod) >= 2:
        off = lod[-2]
        seg = np.array([off[i + 1] - off[i] for i in range(len(off) - 1)],
                       dtype=np.int32)
    return padded, lens, seg


def unpad_to_lod_tensor(padded, lens):
    """(padded [B, T, ...], lengths [B]) -> packed LoDTensor."""
    rows = [padded[i, :int(n)] for i, n in enumerate(lens)]
    packed = np.concatenate(rows, axis=0) if rows else padded[:0, 0]
    t = LoDTensor(packed)
    t.set_recursive_sequence_lengths([[int(n) for n in lens]])
    return t


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """A LoDTensor of `data` (an array of packed rows, or a list of
    per-sequence row arrays) with the given sequence lengths."""
    if isinstance(data, list):
        flat = np.concatenate([np.asarray(x).reshape(len(x), -1)
                               for x in data], axis=0)
        t = LoDTensor(flat)
    else:
        t = LoDTensor(np.asarray(data))
    t.set_recursive_sequence_lengths(recursive_seq_lens)
    if not t.has_valid_recursive_sequence_lengths():
        raise ValueError("create_lod_tensor: the lengths %r do not sum to "
                         "the %d rows" % (recursive_seq_lens,
                                          t.shape()[0]))
    return t


def nested_samples_to_lod_tensor(col, dtype):
    """A batch of nested samples (each a list of inner sequences, each a
    list or array of rows) -> a 2-level LoDTensor, as DataFeeder feeds a
    lod_level-2 var."""
    outer = [len(s) for s in col]
    inners = [np.asarray(inner, dtype=dtype).reshape(len(inner), -1)
              for s in col for inner in s]
    return create_lod_tensor(inners, [outer, [len(i) for i in inners]])


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place,
                                low, high):
    """A random int64 ragged tensor with the given sequence lengths, ids
    in [low, high] from numpy's global generator."""
    total = sum(recursive_seq_lens[-1])
    data = np.random.randint(low, high + 1,
                             size=[total] + list(base_shape)).astype("int64")
    return create_lod_tensor(data, recursive_seq_lens, place)
