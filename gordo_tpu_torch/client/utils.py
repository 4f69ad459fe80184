"""
``PredictionResult``: the port's counterpart of
``gordo_tpu/client/utils.py``, its ``predictions`` a
:class:`~gordo_tpu_torch.models.utils.RawFrame` (the counterpart of the
MultiIndex frame: one group a top-level block, the ``start``/``end``
columns from its index and frequency).
"""

from dataclasses import dataclass, field
from typing import List, Optional

from ..models.utils import RawFrame


@dataclass(frozen=True)
class PredictionResult:
    name: str
    predictions: Optional[RawFrame]
    error_messages: List[str] = field(default_factory=list)
