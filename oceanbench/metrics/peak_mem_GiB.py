"""peak_mem_GiB: `torch.cuda.max_memory_allocated` over the traced run's window, after a
reset at its start, less the device tensors that the benchmark holds for the
judge (`Records.hold`): the program's state, its graph pools and workspaces."""


def read(rec):
    return None if rec.window_peak_bytes is None else rec.window_peak_bytes / 2 ** 30
