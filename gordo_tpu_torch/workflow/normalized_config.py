"""
``NormalizedConfig``: a project config (``machines`` and ``globals``)
merged with the defaults into ``Machine`` s. The port's counterpart of
``gordo_tpu/workflow/normalized_config.py``, with the same defaults.
"""

from typing import Any, Dict, List, Optional

from ..machine import Machine
from .helpers import patch_dict


class NormalizedConfig:
    """Normalize a config dict into a list of validated Machines."""

    DEFAULT_CONFIG_GLOBALS: Dict[str, Any] = {
        "runtime": {
            "reporters": [],
            "server": {
                "resources": {
                    "requests": {"memory": 3000, "cpu": 1000},
                    "limits": {"memory": 6000, "cpu": 2000},
                }
            },
            "builder": {
                "resources": {
                    "requests": {"memory": 3900, "cpu": 1001},
                    "limits": {"memory": 31200},
                },
                "remote_logging": {"enable": False},
            },
            "client": {
                "resources": {
                    "requests": {"memory": 3500, "cpu": 100},
                    "limits": {"memory": 4000, "cpu": 2000},
                },
                "max_instances": 30,
            },
            "prometheus_metrics_server": {
                "resources": {
                    "requests": {"memory": 200, "cpu": 100},
                    "limits": {"memory": 1000, "cpu": 200},
                }
            },
            "influx": {"enable": True},
        },
        "evaluation": {
            "cv_mode": "full_build",
            "scoring_scaler": "sklearn.preprocessing.MinMaxScaler",
            "metrics": [
                "explained_variance_score",
                "r2_score",
                "mean_squared_error",
                "mean_absolute_error",
            ],
        },
    }

    def __init__(self, config: dict, project_name: str, gordo_version: Optional[str] = None):
        self.project_name = project_name
        default_globals = patch_dict({}, self.DEFAULT_CONFIG_GLOBALS)
        self.globals: dict = patch_dict(default_globals, config.get("globals") or {})
        self.machines: List[Machine] = [
            Machine.from_config(conf, project_name=project_name, config_globals=self.globals)
            for conf in config["machines"]
        ]
