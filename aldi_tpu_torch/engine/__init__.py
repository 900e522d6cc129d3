"""The port's training step, trainer, evaluation, checkpoints, serving
entry point and artifact, and weight conversion."""

from .export import (ServingModel, export_inference, load_artifact,  # noqa: F401
                     make_serving_fn, save_artifact)
