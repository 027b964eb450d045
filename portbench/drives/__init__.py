"""The ways a cell drives the program, one file each, found by the
traffic mix's ``entry`` (``portbench/manifest.py``)."""
