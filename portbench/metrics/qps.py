"""qps: queries answered inside the window (ids and distances in host
memory) over the window's seconds."""


def read(run):
    return run.window.completed / run.window.seconds
