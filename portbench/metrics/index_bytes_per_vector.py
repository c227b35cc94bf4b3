"""index_bytes_per_vector: device memory the built, warmed-up index holds
(the benchmark's own tensors freed), over the corpus rows."""


def read(run):
    if not run.index_bytes:
        return None
    return run.index_bytes / run.rows
