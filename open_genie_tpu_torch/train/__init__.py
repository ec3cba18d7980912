"""Training of the port: the objective modules and the optimizer step."""
