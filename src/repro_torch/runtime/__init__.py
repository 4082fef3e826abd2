"""Training runtime of the port: the step functions (``steps``) and the
training loop (``loop``)."""
