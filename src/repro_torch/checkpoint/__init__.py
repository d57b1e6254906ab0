"""Checkpointing of the stepper's state (the reference's file format)."""
