"""Unique name generator, a copy of paddle_tpu/fluid/unique_name.py: the
same keys and counters, so programs built the same way in both packages
name their variables alike."""

import contextlib

__all__ = ["generate", "switch", "guard"]


class UniqueNameGenerator:
    def __init__(self, prefix=""):
        self.ids = {}
        self.prefix = prefix

    def __call__(self, key):
        if key not in self.ids:
            self.ids[key] = 0
        tmp = self.ids[key]
        self.ids[key] += 1
        return self.prefix + "_".join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


def switch(new_generator=None):
    global generator
    old = generator
    if new_generator is None:
        generator = UniqueNameGenerator()
    else:
        generator = new_generator
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
