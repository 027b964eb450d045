"""The operation and byte counts of the port's kernels, and the card's
published peaks: the yardstick of the ``*_roofline`` metrics.  Copied from
the arithmetic of ``chip_smoke.py`` (``k2_bound``, ``k5_bound``),
with the kernels' field counts of this benchmark's version of the port
written out, so that a change to the program does not move them.

One module a kernel, found by name: a per-layer metric that names it
(``ROOFLINE = "<kernel>"`` in ``metrics/<metric>.py``) has the harness
call its ``launch_ms(run)`` on the traced run (``run``: ``config``,
``files``, ``ncol``, ``traced``, what the drive's ``traced()`` returned,
and ``measured``, the untraced window's readings), which returns the
bound of one launch in ms, or None where there is nothing to count from.
Each ``bound`` gives (bytes ms, operations ms) of one launch; the bound is
the larger."""
