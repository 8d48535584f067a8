"""Serving runtime of the port (the continuous-batching LM engine)."""
