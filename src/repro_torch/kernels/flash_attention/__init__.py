"""Flash attention: causal / sliding-window GQA forward (the LM prefill)."""
