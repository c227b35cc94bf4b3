"""score_ms: device ms a batch of the work that the program launches in
its ``score`` stage (the launches before its ``score`` stage mark and after
the mark before it), from the traced window's device trace: the union of
those kernels', copies' and memsets' intervals, summed over the batches
dispatched in the traced span, over the batches (harness/trace.py)."""

STAGE = "score"


def read(run):
    if not run.stage_ms or STAGE not in run.stage_ms:
        return None
    return run.stage_ms[STAGE]
