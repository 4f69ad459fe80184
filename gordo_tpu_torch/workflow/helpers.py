"""
``patch_dict``: the port's counterpart of ``gordo_tpu/workflow/helpers.py``.
"""

import copy


def patch_dict(original_dict: dict, patch_dictionary: dict) -> dict:
    """``patch_dictionary`` laid over a copy of ``original_dict``: every
    path in the patch is added or replaced, nothing is removed.

    >>> patch_dict({"a": {"b": 1, "c": 2}}, {"a": {"b": 10}})
    {'a': {'b': 10, 'c': 2}}
    """
    result = copy.deepcopy(original_dict)

    def _merge(base: dict, patch: dict):
        for key, value in patch.items():
            if isinstance(value, dict) and isinstance(base.get(key), dict):
                _merge(base[key], value)
            else:
                base[key] = copy.deepcopy(value)

    _merge(result, patch_dictionary or {})
    return result
