"""Drivers of the benchmark's kinds of traffic, one module a kind.

A driver's ``Workload(ctx)`` has ``setup()`` (inputs from the seed and the
port's objects), ``warm()`` (every shape the window uses), ``unit()`` (one
closed-loop unit of work, returning its input bases), ``counters()``
(program counters by name), ``release()`` (drops the port's state) and
``check()`` (``(name, number, limit)`` comparisons with the plain
reference).  ``metric`` names the end-to-end rate it reports.
"""
