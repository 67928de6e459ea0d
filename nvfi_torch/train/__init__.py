"""Training side of the port: the train step, the stage loop (``Trainer``), the
optimizer, checkpoints, turbo's budget probe and the weight carry-across."""
