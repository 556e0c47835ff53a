"""Transmitter twin and the Pyramid collision decoder."""
