"""CPU tests of the benchmark (card-only ones skip without a card):

    python -m pytest port_bench/tests -q -o addopts=""
"""
