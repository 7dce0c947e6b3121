"""Serving of the port: the continuous-batching engine."""
