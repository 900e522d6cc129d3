"""The port's training step, trainer, evaluation, checkpoints, serving
entry point and weight conversion."""
