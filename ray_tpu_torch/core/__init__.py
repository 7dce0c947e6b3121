"""The port's control-plane pieces (counterpart of the JAX package's
``core/``). Only ``telemetry.py``'s gauge ring and alert state machine are
here, for the serve autoscaler; the rest of the control plane is still to
be ported."""
