"""The whole step's share of the card's bf16 peak while the card runs the
model (%): the model FLOPs of the tokens processed in the window (the
architecture module's counts, ``portbench/archs/granitemoehybrid.py``: 2 x
the active parameters a token, 10 of 72 experts and the shared expert, plus
attention over its context on the 4 attention layers and the scan on the 36
Mamba-2 layers; a prompt counted when its first token comes in the window)
over the pool's busy time on the card (CUDA events around its calls into
the model) times 989 TFLOP/s.  In an open loop the FLOPs of a window are
set by the offered rate, so the share is over the busy time, not the
window; traced runs only."""


def read(facts, trace):
    if trace is None or not facts.get("flops_in_window"):
        return None
    busy = trace.busy_s()
    if busy <= 0:
        return None
    return 100.0 * facts["flops_in_window"] / (busy * facts["peak_flops"])
