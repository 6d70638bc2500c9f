"""Model stack of the port: params, layers, attention, the LM, conversion."""
