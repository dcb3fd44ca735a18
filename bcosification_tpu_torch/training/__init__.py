"""Supervised training of the port: train and eval steps, AGC, EMA,
checkpoints, the metrics record and the Trainer."""
