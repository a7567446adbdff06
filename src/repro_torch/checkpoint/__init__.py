"""Checkpoints (counterpart of `repro.checkpoint`): `store`, in the
reference's on-disk format."""
