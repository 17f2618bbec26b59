"""The benchmark of repro_torch, the PyTorch + CUDA port.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line.  Everything that belongs to one configuration, traffic
mix, metric or cell sits in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``,
``limits/<cell>.json``; ``runners/<kind>.py`` drives the program for a kind
of traffic and ``reference/<name>.py`` is the plain reference a
configuration names.
"""
