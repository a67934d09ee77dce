"""The benchmark's own code: the yardstick that later changes to the
program are measured against.  Nothing here imports the program at module
level; ``system`` and ``window`` import ``repro_torch`` inside functions.
"""
