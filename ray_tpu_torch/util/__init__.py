"""Utilities of the port: the host collectives (``util.collective``)."""
