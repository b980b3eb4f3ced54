"""Compiler and executor of the port."""
