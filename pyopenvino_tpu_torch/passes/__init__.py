"""Compile-time graph passes of the port."""
