"""Drivers of the benchmark, one module a kind of traffic."""
