"""The whole step's share of the card's bf16 peak over the window (%): the
model FLOPs of the tokens processed in the window (the architecture
module's counts, ``portbench/archs/granitemoe.py``: 2 x the active
parameters a token, 8 of 40 experts, plus attention over its context; a
prompt counted when its first token comes in the window)
over the window's length times 989 TFLOP/s."""


def read(facts, trace):
    w = facts.get("window_s", 0.0)
    if w <= 0 or not facts.get("flops_in_window"):
        return None
    return 100.0 * facts["flops_in_window"] / (w * facts["peak_flops"])
