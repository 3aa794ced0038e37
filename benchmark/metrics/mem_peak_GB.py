"""The card's allocation peak over the warm-up and the window, in GB
(``torch.cuda.max_memory_allocated``)."""


def read(run):
    return run.mem_peak_bytes / 1e9 if run.mem_peak_bytes else None
