"""Angle arithmetic, exact scalar division and host-sync accounting."""
