"""dedup_ms: device ms a batch of the work that the program launches in
its ``dedup`` stage (SOAR's drop of each row's second copy and the top
k_pre after it, between the ``merge`` and the ``dedup`` stage marks), from
the traced window's device trace: the union of those kernels', copies'
and memsets' intervals, summed over the batches dispatched in the traced
span, over the batches (harness/trace.py).  None where the program marks
no such stage."""

STAGE = "dedup"


def read(run):
    if not run.stage_ms or STAGE not in run.stage_ms:
        return None
    return run.stage_ms[STAGE]
