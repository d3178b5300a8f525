"""Decorator metadata copying WITHOUT functools.wraps: wraps sets
__wrapped__, which pytest follows to the innermost function and then
misreads (spec, state) as fixture names. We copy only the display
attributes."""


def copy_meta(entry, fn):
    entry.__name__ = getattr(fn, "__name__", entry.__name__)
    entry.__qualname__ = getattr(fn, "__qualname__", entry.__qualname__)
    entry.__doc__ = getattr(fn, "__doc__", None)
    entry.__module__ = getattr(fn, "__module__", entry.__module__)
    return entry
