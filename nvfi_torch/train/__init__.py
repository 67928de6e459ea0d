"""Training side of the port: the train step, the optimizer, checkpoints and the weight
carry-across."""
