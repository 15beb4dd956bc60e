"""SelectedRows — sparse row-set gradients for embeddings, after
paddle_tpu/fluid/selected_rows.py.

`lookup_table_sparse_grad` (ops/nn_ops.py) makes one when an embedding
was built with is_sparse=True: rows int32 [K] (the looked-up ids),
values [K, D] (the output cotangent rows) and the table's static height.
The optimizer lowerings (ops/optimizer_ops.py) take a row-wise update
path on it, whose cost scales with the touched rows, or densify it where
their state is dense.  It lives in the step's env like a tensor, and a
fetch of it comes back as one of numpy arrays.

Padding: `merged()` keeps K entries (rows unique, ascending, then padded
with the out-of-range id `height`), so its shapes do not depend on the
data; every scatter here drops the padding ids, as the JAX package's
`mode="drop"` does, and a gather clamps them to the last row (the value
read there is never written back)."""

import torch

__all__ = ["SelectedRowsValue"]


class SelectedRowsValue:
    """rows [K] int32, values [K, D], height = table size (static)."""

    __slots__ = ("rows", "values", "height")

    def __init__(self, rows, values, height):
        self.rows = rows
        self.values = values
        self.height = int(height)

    def get_rows(self):
        return self.rows

    def get_tensor(self):
        return self.values

    def get_height(self):
        return self.height

    def valid(self):
        """[K] bool: the entries whose row lies in the table."""
        return (self.rows >= 0) & (self.rows < self.height)

    def to_dense(self):
        """[height, D] with each entry's values summed into its row; the
        padding ids (>= height) land nowhere."""
        valid = self.valid()
        dense = torch.zeros((self.height,) + tuple(self.values.shape[1:]),
                            dtype=self.values.dtype,
                            device=self.values.device)
        return dense.index_add(0, torch.where(valid, self.rows, 0).long(),
                               self.values * valid.view(
                                   (-1,) + (1,) * (self.values.dim() - 1))
                               .to(self.values.dtype))

    def merged(self):
        """Rows deduplicated, ascending, their values summed; K entries,
        padded with the id `height` and zero values."""
        # no data-dependent shape (no host sync on the card): a stable
        # sort, each entry's segment (its row's rank among the distinct
        # rows), then one scatter of the rows and one add of the values
        srt, perm = torch.sort(self.rows, stable=True)
        first = torch.ones_like(srt, dtype=torch.bool)
        first[1:] = srt[1:] != srt[:-1]
        seg = torch.cumsum(first.long(), 0) - 1
        rows = torch.full_like(self.rows, self.height, dtype=torch.int32)
        rows = rows.scatter(0, seg, srt.to(torch.int32))
        summed = torch.zeros_like(self.values).index_add(
            0, seg, self.values[perm])
        return SelectedRowsValue(rows, summed, self.height)

    def __repr__(self):
        return "SelectedRows(rows=%s, values=%s, height=%d)" % (
            tuple(getattr(self.rows, "shape", ())),
            tuple(getattr(self.values, "shape", ())), self.height)
