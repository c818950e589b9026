"""Synthetic VM telemetry (numpy, carried over from `repro.sim`)."""
