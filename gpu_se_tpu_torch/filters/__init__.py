"""Particle filters and plain resampling."""
