"""Oblivious-forest inference kernel."""
