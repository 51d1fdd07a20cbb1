"""The device memory the run's tensors held at its peak,
``torch.cuda.max_memory_allocated()`` up to the window's close, in MiB."""


def read(rec, variant):
    return rec.peak_mem_bytes / 2 ** 20 if rec.peak_mem_bytes else None
