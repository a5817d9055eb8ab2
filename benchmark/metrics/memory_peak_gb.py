"""memory_peak_gb: the peak of device memory that the program's tensors
held in the run (torch.cuda.max_memory_allocated, read once the window
has closed and before the reference check), in 10^9 bytes."""


def read(rec):
    peak = rec.get("memory_peak_bytes")
    return peak / 1e9 if peak else None
