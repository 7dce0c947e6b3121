"""Utilities of the port: the host collectives (``util.collective``), the
process core (``util.procs``), and the metrics, tracing and state APIs of
the serve trace plane (``util.metrics``, ``util.tracing``,
``util.state``)."""
