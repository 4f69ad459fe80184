from .from_definition import from_definition, load_params_from_definition  # noqa: F401
from .into_definition import into_definition  # noqa: F401
from .serializer import (  # noqa: F401
    dump, dumps, load, load_metadata, load_model_json, loads, unpack)
