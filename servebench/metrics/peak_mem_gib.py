"""Peak device memory of the run up to the window's close, in GiB
(``torch.cuda.max_memory_allocated``)."""


def read(run):
    return run.memory_peak_bytes / 2 ** 30
