"""Kinds of traffic, one module each, found by the ``kind`` of a traffic
file: ``run(cell, ctx) -> harness.Outcome`` drives the program through one
run, and ``control(cell, device)`` gives the reference in a lower precision
to put in the program's place."""
