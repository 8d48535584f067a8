"""Median device time of one paged prefill chunk over the window (ms): CUDA
events on the pool's stream around each of the pool's chunk calls into the
model (one graph replay of up to 256 positions through every layer, and
its copies in and out), in traced runs."""


def read(facts, trace):
    return trace.median_ms("prefill chunk") if trace is not None else None
