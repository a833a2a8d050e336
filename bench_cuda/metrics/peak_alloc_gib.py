"""peak_alloc_gib (device): ``torch.cuda.max_memory_allocated()`` over the
window, after ``reset_peak_memory_stats()`` at its start, in GiB: the
memory that bounds the rows of a call. None off a card."""


def read(run):
    return run.peak_window_bytes / 2 ** 30 if run.peak_window_bytes else None
