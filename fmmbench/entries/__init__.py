"""Entries: how a traffic mix drives the program (one module each)."""
