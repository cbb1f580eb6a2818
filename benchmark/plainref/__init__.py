"""Frozen plain copies of esvo_tpu_torch modules."""
