"""Utilities: RNG replicas, timers, synthetic data, simulation."""
