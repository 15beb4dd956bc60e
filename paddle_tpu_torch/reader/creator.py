"""Reader creators, after paddle_tpu/reader/creator.py (reference
python/paddle/reader/creator.py): readers over a numpy array and over a
text file.  The recordio creator needs the recordio scanner, which is
not ported (ROADMAP.md, queue 1 item 13), and raises."""

__all__ = ["np_array", "text_file", "recordio"]


def np_array(x):
    """A reader yielding the rows of a numpy array (reference
    creator.py:22)."""

    def reader():
        for row in x:
            yield row

    return reader


def text_file(path):
    """A reader yielding the lines of a text file, trailing newline
    stripped (reference creator.py:42)."""

    def reader():
        with open(path, "r") as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths, buf_size=100):
    """A reader over recordio files (reference creator.py:60): needs the
    recordio scanner, not ported to paddle_tpu_torch yet."""
    raise NotImplementedError(
        "reader.creator.recordio: the recordio scanner and "
        "fluid.recordio_writer are not ported to paddle_tpu_torch yet "
        "(ROADMAP.md, queue 1 item 13)")
