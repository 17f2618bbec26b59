"""Drivers of the program, one a kind of traffic (``traffic/*.json``'s
``kind``).  These are the only modules of the benchmark that import
repro_torch."""
