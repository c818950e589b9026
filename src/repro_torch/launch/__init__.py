"""Serving launchers of the LM substrate: the prefill and one-token
decode steps, and batched greedy serving."""
