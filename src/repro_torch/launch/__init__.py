"""Entry points of the port: ``serve`` (sketch-filtered LM serving)."""
