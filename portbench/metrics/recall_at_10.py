"""recall_at_10: recall@10 of every query answered inside the window
against the reference's exact top 10."""


def read(run):
    return run.recall_in_window
