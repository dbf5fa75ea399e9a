"""The benchmark of ``tpu_viterbi_torch`` on the card: ``python3 -m
benchmark.run`` runs one cell of ``BENCHMARK.json`` once (``run.py``).  Its
yardstick lives here: the traffic, the plain reference, the rooflines and
the reading of the trace; from the program it takes only the entries it
drives, their spans and their kernels' names."""
