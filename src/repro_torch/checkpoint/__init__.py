"""Checkpoint save and restore (``checkpointing``)."""
