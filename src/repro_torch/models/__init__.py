"""Model stack of the port: configs, parameter trees, layers, the LM."""
