"""Measurement and motion models."""
