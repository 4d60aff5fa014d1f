"""Entries of the benchmark: one module per kind of traffic, named by the mix's ``entry``."""
