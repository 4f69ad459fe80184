"""Model factories of the port: ``kind`` name -> ModelSpec builder."""

from .transformer import transformer_model

FACTORIES = {"transformer_model": transformer_model}
