"""Training of the port: the one-device train step."""
