"""Mamba2 SSD chunked-scan kernel."""
