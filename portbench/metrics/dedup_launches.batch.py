"""dedup_launches.batch: kernel launches, copies and memsets a batch that
the program enqueues in its ``dedup`` stage, over the traced window's
batches (harness/trace.py).  None where the program marks no such
stage."""

STAGE = "dedup"


def read(run):
    if run.trace is None:
        return None
    return run.trace["launches"].get(STAGE)
