"""The port's control-plane pieces (counterpart of the JAX package's
``core/``): ``telemetry.py`` (the metrics ring and alert state machine
the serve autoscaler and the sink run on), ``events.py`` (structured
events) and ``sink.py`` (the app-metric ingest, the Prometheus text and
``/metrics`` responder and the TSDB the JAX package keeps in its cluster
controller; here a serve controller owns one) and ``checkpoint.py`` (the
host-local record store under the data layer's ingest cursors and
split journals, and the actors' checkpoints). On one host, the core
itself: ``api.py`` (tasks, actors, objects), ``worker.py`` (the actor and
task processes), ``serialization.py``, ``context.py``, ``ids.py`` and
``object_store.py`` (the compiled DAG's slot rings). The rest of the
control plane is still to be ported."""
