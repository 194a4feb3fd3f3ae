"""Peak device memory over the window (``torch.cuda.max_memory_allocated``
after a reset at its start), in GB."""


def read(r):
    v = r.get("train_peak_bytes")
    return None if not v else v / 1e9
