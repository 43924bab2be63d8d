"""The op capture's hook into the kernel wrappers and the collectives.

A kernel wrapper hands its card path to a ctypes call, which a
``TorchDispatchMode`` cannot see, and on the CPU runs its plain version,
whose own aten ops the capture must not count as the step's (the card
never runs them).  So every wrapper that counts launches, and every worker
of ``parallel/collectives.py``, starts with::

    if account.recorder is not None:
        return account.recorder.kernel("<launch key>", <wrapper>, **locals())

``recorder`` is None unless an op capture (``analysis/graph.py``,
``capture``) is running: then the call costs one ``is None`` test.  While a
capture runs, the recorder takes one entry per call (the name, which is the
wrapper's launch-counter key, and its arguments) and calls the wrapper
again with the recorder set aside, so the kernel launches (and counts) as
it would, or the plain version runs, and the capture ignores the aten ops
inside the call.  The CPU run and the card run then capture the same step.
"""
from __future__ import annotations

# the active recorder (``analysis.graph._Capture``), or None
recorder = None
