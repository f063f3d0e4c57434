"""The card's peak allocated memory over the window, in GiB
(``torch.cuda.max_memory_allocated`` after a reset at the window's start).
One reader for every cell's ``peak_mem_gib.<cell kind>``."""


def read(w):
    return w.memory_peak_bytes / 2**30 if w.memory_peak_bytes else None
