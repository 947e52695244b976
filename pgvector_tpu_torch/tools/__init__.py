"""Measurement tools that run on the card (``python -m
pgvector_tpu_torch.tools.<name>``); nothing in the package imports them."""
