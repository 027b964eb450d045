"""The benchmark's input kinds, one file each, found by the key a
configuration's ``inputs`` names (``portbench/manifest.py``)."""
