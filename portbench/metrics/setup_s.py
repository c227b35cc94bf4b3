"""setup_s: process start to the window's start (imports, corpus, build,
warm-up)."""


def read(run):
    return run.setup_s
