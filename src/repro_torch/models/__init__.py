"""The dense decoder-only LM of the port (``llama3.2-3b``)."""
