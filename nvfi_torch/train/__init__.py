"""Training side of the port: checkpoints, the weight carry-across and grid helpers."""
