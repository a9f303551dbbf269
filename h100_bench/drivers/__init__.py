"""Drivers: one module a kind of cell, named by a mix's ``driver``."""
