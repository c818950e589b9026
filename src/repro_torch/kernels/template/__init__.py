"""Criticality template-scoring kernel."""
