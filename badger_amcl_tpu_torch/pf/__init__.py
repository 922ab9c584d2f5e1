"""Particle filter core: state, KLD sampling, clustering, resampling."""
