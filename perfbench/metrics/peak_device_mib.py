"""Peak device memory of the run (torch.cuda.max_memory_allocated after
reset_peak_memory_stats at set-up), MiB."""


def read(run):
    tr = run.trace
    return tr.peak_mib if tr is not None and tr.peak_mib > 0 else None
