"""Training optimizers of the port: AdamW with the reference's arithmetic,
and int8 error-feedback gradient compression over a data mesh."""
from .adamw import AdamWConfig, AdamWState, lr_schedule, make_adamw

__all__ = ["AdamWConfig", "AdamWState", "lr_schedule", "make_adamw"]
