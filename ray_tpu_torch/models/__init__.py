"""Models of the port: transformer, configs, int8 weights, decoding."""
