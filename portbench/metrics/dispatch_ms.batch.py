"""dispatch_ms.batch: host ms from the call to search_batched_async until
it returns, averaged over the traced window's batches."""


def read(run):
    d = run.window.dispatch_s
    if not d or run.trace is None:
        return None
    return 1e3 * sum(d) / len(d)
