"""score_roofline: the least time a batch's scoring work needs on the card
(portbench/work/<config's score_work>.py, against the peaks of
harness/peaks.py) over the device time of the ``score`` stage a batch
(score_ms, from the device trace), in %."""


def read(run):
    if run.score_least_ms is None or not run.stage_ms \
            or not run.stage_ms.get("score"):
        return None
    return 100.0 * run.score_least_ms / run.stage_ms["score"]
