"""
Live objects to definitions: the port's counterpart of
``gordo_tpu/serializer/into_definition.py``. Objects are named by the paths
of the JAX package's counterparts (resolver.py), so a definition the port
writes is the one the JAX package writes for the same model.
"""

from .resolver import definition_path


def into_definition(pipeline) -> dict:
    """A primitives-only definition of a live pipeline or estimator that
    :func:`~gordo_tpu_torch.serializer.from_definition` builds again."""
    return _decompose_node(pipeline)


def _decompose_node(step: object) -> dict:
    if hasattr(type(step), "into_definition"):
        definition = step.into_definition()
    else:
        definition = load_definition_from_params(step.get_params(deep=False))
    return {definition_path(type(step)): definition}


def load_definition_from_params(params: dict) -> dict:
    """Each parameter value decomposed into primitives."""
    definition: dict = {}
    for param, param_val in params.items():
        if hasattr(type(param_val), "get_params") or hasattr(type(param_val), "into_definition"):
            definition[param] = _decompose_node(param_val)
        elif isinstance(param_val, list):
            definition[param] = [
                _decompose_node(leaf[1]) if isinstance(leaf, tuple) else leaf
                for leaf in param_val
            ]
        elif callable(param_val):
            definition[param] = definition_path(param_val)
        else:
            definition[param] = param_val
    return definition
