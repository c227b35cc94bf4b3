"""build_s: host seconds of the index build (``builder(...).build()``,
synchronized)."""


def read(run):
    return run.build_s
