"""Scaling on the card: batched worlds and split-frame bands."""
