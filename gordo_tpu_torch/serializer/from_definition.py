"""
Definitions to live objects: the port's counterpart of
``gordo_tpu/serializer/from_definition.py``, with the same rules.

A definition is a dict with one path key mapping to the keyword arguments,
or a bare path. ``Pipeline`` steps and ``FeatureUnion`` transformers
recurse (named ``step_0``, ``step_1``, ...); a class with a
``from_definition`` classmethod gets the raw arguments; string arguments that name a function become that function;
arguments that are themselves definitions are built. Paths resolve from
the port's table (resolver.py). ``device`` goes to every estimator built,
as the device it trains and predicts on.
"""

import copy
from typing import Any, Dict, Iterable, Union

from ..models.scaler import FeatureUnion, Pipeline
from .resolver import locate


def from_definition(pipe_definition: Union[str, Dict[str, Dict[str, Any]]], device=None):
    """A live estimator or pipeline from a definition dict."""
    return _build_step(copy.deepcopy(pipe_definition), device)


def _locate_or_raise(path: str):
    obj = locate(path)
    if obj is None:
        raise ImportError(f'Could not locate path: "{path}"')
    return obj


def _build_scikit_branch(definition: Iterable, device):
    return [(f"step_{i}", _build_step(step, device)) for i, step in enumerate(definition)]


def _build_step(step, device):
    if isinstance(step, dict):
        if len(step) != 1:
            return _load_param_classes(step, device)
        import_str = next(iter(step))
        StepClass = _locate_or_raise(import_str)
        # a step written as `Class:` with an empty body parses to {path: None}
        params = step[import_str] or {}
        if hasattr(StepClass, "from_definition"):
            return StepClass.from_definition(params, device=device)
        if isinstance(params, dict):
            params = _load_param_classes(params, device)
            for param, value in params.items():
                if isinstance(value, str) and callable(locate(value)):
                    params[param] = locate(value)
        if StepClass in (FeatureUnion, Pipeline):
            if isinstance(params, dict) and "transformer_list" in params:
                params["transformer_list"] = _build_scikit_branch(params["transformer_list"],
                                                                  device)
            elif isinstance(params, dict) and "steps" in params:
                params["steps"] = _build_scikit_branch(params["steps"], device)
            elif isinstance(params, (tuple, list)):
                return StepClass(_build_scikit_branch(params, device))
            else:
                raise ValueError(
                    f"Got {StepClass} but the supplied parameters seem invalid: {params}"
                )
        return StepClass(**params)
    if isinstance(step, str):
        StepClass = _locate_or_raise(step)
        if hasattr(StepClass, "from_definition"):
            return StepClass.from_definition({}, device=device)
        return StepClass()
    raise ValueError(f"Expected step to be str or dict, found: {type(step)}")


def build_callbacks(definitions: list) -> list:
    """Training callbacks (``EarlyStopping``) from their definitions; live
    callbacks pass as they are."""
    return [_build_step(callback, None) if isinstance(callback, (dict, str)) else callback
            for callback in definitions]


def _load_param_classes(params: dict, device=None) -> dict:
    """``params`` with each value that names a class (a path, or a
    one-key definition) replaced by an instance of it."""
    params = copy.copy(params)
    for key, value in params.items():
        if isinstance(value, str):
            Model = locate(value)
            if Model is not None:
                if hasattr(Model, "from_definition"):
                    params[key] = Model.from_definition({}, device=device)
                elif isinstance(Model, type):
                    params[key] = Model()
        elif isinstance(value, dict) and len(value) == 1 and isinstance(
            next(iter(value.values())), dict
        ):
            import_path = next(iter(value))
            Model = locate(import_path)
            sub_params = value[import_path]
            if Model is not None and hasattr(Model, "from_definition"):
                params[key] = Model.from_definition(sub_params, device=device)
            elif Model is Pipeline:
                params[key] = from_definition(value, device)
            elif isinstance(Model, type):
                params[key] = Model(**_load_param_classes(sub_params, device))
        elif key == "callbacks" and isinstance(value, list):
            params[key] = build_callbacks(value)
    return params


def load_params_from_definition(definition: dict, device=None) -> dict:
    """Each value of a dict (an estimator's arguments) built from its
    definition where it is one."""
    if not isinstance(definition, dict):
        raise ValueError(f"Expected definition to be a dict, found: {type(definition)}")
    return _load_param_classes(definition, device)
