"""Training of the port: the objective modules, the train step and its
state, checkpoints, the YAML config and the trainer loop."""
