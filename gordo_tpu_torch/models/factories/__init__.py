"""Model factories of the port: for each estimator class (its
``factory_type``), the ``kind`` names it takes and their ModelSpec
builders, as the JAX package's ``register_model_builder`` files them."""

from .feedforward_autoencoder import (
    feedforward_hourglass, feedforward_model, feedforward_symmetric,
)
from .lstm_autoencoder import lstm_hourglass, lstm_model, lstm_symmetric
from .tcn import tcn_model
from .transformer import moe_transformer_model, transformer_model

_LSTM = {f.__name__: f for f in (lstm_model, lstm_symmetric, lstm_hourglass)}
_TCN = {"tcn_model": tcn_model}
_TRANSFORMER = {f.__name__: f for f in (transformer_model, moe_transformer_model)}
FACTORIES = {
    "AutoEncoder": {f.__name__: f for f in (feedforward_model, feedforward_symmetric,
                                            feedforward_hourglass)},
    "LSTMAutoEncoder": _LSTM,
    "LSTMForecast": _LSTM,
    "TransformerAutoEncoder": _TRANSFORMER,
    "TransformerForecast": _TRANSFORMER,
    "TCNAutoEncoder": _TCN,
    "TCNForecast": _TCN,
}
