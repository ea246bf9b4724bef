"""Kernels the card ran per training step in the traced window (every
kernel the profiler recorded, copies and fills left out)."""


def read(rec):
    if rec["trace"] is None or not rec["traced_units"]:
        return None
    return len(rec["trace"].kernels()) / len(rec["traced_units"])
