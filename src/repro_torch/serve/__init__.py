"""Serving: prefill and greedy decode for the LM substrate."""
