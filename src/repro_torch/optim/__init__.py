"""Optimizers (counterpart of `repro.optim`): `adamw`, the reference's AdamW
with f32 moments, updated in place."""
