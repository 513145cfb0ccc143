"""Measurement tools that run on an NVIDIA GPU; nothing on the serving path
imports them."""
