"""Median device time of one paged decode step over the window (ms): CUDA
events on the pool's stream around each of the pool's calls into the model
step (one graph replay, with every slot's SSM state update, and its copies
in and out), in traced runs."""


def read(facts, trace):
    return facts.get("decode_step_ms")
