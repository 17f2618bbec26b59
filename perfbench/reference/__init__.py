"""Plain references, one a configuration (``configs/*.json``'s
``reference``).  They import neither JAX, nor the JAX package, nor anything
of repro_torch: they take the inputs and weights the benchmark made, work
out again whatever the program derived from them, and judge the program's
outputs.  Each module has ``readings(payload, config, traffic)`` (the
numbers compared with the cell's limits) and ``control(payload, config,
traffic)`` (the same numbers for the reference computed in the nearest
precision below the configuration's, which the limits must fail)."""
