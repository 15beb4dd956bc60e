"""Reader creators, after paddle_tpu/reader/creator.py (reference
python/paddle/reader/creator.py): readers over a numpy array, a text
file and RecordIO files."""

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
    """A reader over RecordIO file(s) (reference creator.py:60): each
    record as the bytes written, e.g. by fluid.recordio_writer.  `paths`
    is a list or a comma-separated string."""
    if isinstance(paths, str):
        paths = paths.split(",")

    def reader():
        from ..native import RecordIOScanner
        for path in paths:
            with RecordIOScanner(path) as s:
                for record in s:
                    yield record

    return reader
