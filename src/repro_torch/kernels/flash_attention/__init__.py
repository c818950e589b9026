"""Prefill flash attention kernel."""
