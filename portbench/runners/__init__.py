"""Runners by a traffic mix's ``kind``: ``portbench/runners/<kind>.py``
with ``run(cell, seed, seconds, trace, dev, t_start)``."""
