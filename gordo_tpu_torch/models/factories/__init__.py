"""Model factories of the port: for each estimator class (its
``factory_type``), the ``kind`` names it takes and their ModelSpec
builders, as the JAX package's ``register_model_builder`` files them."""

from .feedforward_autoencoder import (
    feedforward_hourglass, feedforward_model, feedforward_symmetric,
)
from .transformer import transformer_model

_TRANSFORMER = {"transformer_model": transformer_model}
FACTORIES = {
    "AutoEncoder": {f.__name__: f for f in (feedforward_model, feedforward_symmetric,
                                            feedforward_hourglass)},
    "TransformerAutoEncoder": _TRANSFORMER,
    "TransformerForecast": _TRANSFORMER,
}
