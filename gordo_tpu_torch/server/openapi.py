"""
The OpenAPI document of the model server's REST surface, served at
``GET /gordo/v0/openapi.json``: the port's own copy of
``gordo_tpu/server/openapi.py``, plain data. It describes the JAX package's
whole surface, ``/metrics`` and ``/debug/*`` included, all of which the
port serves; ``tests/test_torch_fastlane.py`` holds it equal to the JAX
document and its paths over the port's routes.
"""

from .. import __version__

_DF_DICT = {
    "type": "object",
    "description": "Dataframe as {column: {index: value}} "
    "(MultiIndex columns nest one level deeper)",
    "additionalProperties": True,
}

_PREDICTION_BODY = {
    "required": True,
    "content": {
        "application/json": {
            "schema": {
                "type": "object",
                "required": ["X"],
                "properties": {
                    "X": _DF_DICT,
                    "y": _DF_DICT,
                },
            }
        },
        "multipart/form-data": {
            "schema": {
                "type": "object",
                "required": ["X"],
                "properties": {
                    "X": {"type": "string", "format": "binary",
                          "description": "snappy-parquet dataframe"},
                    "y": {"type": "string", "format": "binary"},
                },
            }
        },
    },
}

_REVISION_PARAM = {
    "name": "revision",
    "in": "query",
    "required": False,
    "schema": {"type": "string"},
    "description": "Serve a specific model revision (410 when absent)",
}

_FORMAT_PARAM = {
    "name": "format",
    "in": "query",
    "required": False,
    "schema": {"type": "string", "enum": ["parquet"]},
    "description": "Return snappy-parquet bytes instead of JSON",
}

_PROJECT_PARAM = {
    "name": "gordo_project",
    "in": "path",
    "required": True,
    "schema": {"type": "string"},
}
_NAME_PARAM = {
    "name": "gordo_name",
    "in": "path",
    "required": True,
    "schema": {"type": "string"},
}

_RESPONSE_FRAME = {
    "200": {
        "description": "Prediction frame (data key) or parquet bytes",
        "content": {"application/json": {"schema": _DF_DICT}},
    },
    "400": {"description": "Bad payload / missing X or y"},
    "404": {"description": "No such model"},
    "410": {"description": "Requested revision not available"},
}


def openapi_document() -> dict:
    """The spec as a dict; serialized by the /openapi.json route."""
    machine = f"/gordo/v0/{{gordo_project}}/{{gordo_name}}"
    project = "/gordo/v0/{gordo_project}"
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "gordo-tpu model server",
            "version": __version__,
            "description": "Config-driven timeseries anomaly model serving "
            "(route/payload-compatible with Equinor gordo's server)",
        },
        "paths": {
            f"{machine}/prediction": {
                "post": {
                    "summary": "Run the model's predict/transform over X",
                    "parameters": [
                        _PROJECT_PARAM, _NAME_PARAM, _REVISION_PARAM,
                        _FORMAT_PARAM,
                    ],
                    "requestBody": _PREDICTION_BODY,
                    "responses": _RESPONSE_FRAME,
                }
            },
            f"{machine}/anomaly/prediction": {
                "post": {
                    "summary": "Score anomalies (requires y; diff-based "
                    "detectors only)",
                    "parameters": [
                        _PROJECT_PARAM, _NAME_PARAM, _REVISION_PARAM,
                        _FORMAT_PARAM,
                        {
                            "name": "all_columns",
                            "in": "query",
                            "required": False,
                            "schema": {"type": "string"},
                            "description": "Include smoothed columns",
                        },
                    ],
                    "requestBody": _PREDICTION_BODY,
                    "responses": {
                        **_RESPONSE_FRAME,
                        "422": {
                            "description": "Model is not an anomaly detector"
                        },
                    },
                }
            },
            f"{machine}/metadata": {
                "get": {
                    "summary": "Machine + build metadata",
                    "parameters": [_PROJECT_PARAM, _NAME_PARAM, _REVISION_PARAM],
                    "responses": {"200": {"description": "Metadata document"}},
                }
            },
            f"{machine}/healthcheck": {
                "get": {
                    "summary": "Per-machine probe (alias of /metadata: 200 "
                    "iff the machine's artifact is loadable)",
                    "parameters": [_PROJECT_PARAM, _NAME_PARAM, _REVISION_PARAM],
                    "responses": {"200": {"description": "Machine servable"}},
                }
            },
            f"{machine}/download-model": {
                "get": {
                    "summary": "Serialized model artifact",
                    "parameters": [_PROJECT_PARAM, _NAME_PARAM, _REVISION_PARAM],
                    "responses": {
                        "200": {
                            "description": "Serialized model bytes",
                            "content": {
                                "application/octet-stream": {
                                    "schema": {
                                        "type": "string", "format": "binary"
                                    }
                                }
                            },
                        }
                    },
                }
            },
            f"{project}/models": {
                "get": {
                    "summary": "Model names in the served revision",
                    "parameters": [_PROJECT_PARAM, _REVISION_PARAM],
                    "responses": {"200": {"description": "{models: [...]}"}},
                }
            },
            f"{project}/revisions": {
                "get": {
                    "summary": "Available model-collection revisions",
                    "parameters": [_PROJECT_PARAM],
                    "responses": {
                        "200": {
                            "description":
                            "{latest, available-revisions}"
                        }
                    },
                }
            },
            f"{project}/expected-models": {
                "get": {
                    "summary": "Models the deployment expects to serve",
                    "parameters": [_PROJECT_PARAM],
                    "responses": {
                        "200": {"description": "{expected-models: [...]}"}
                    },
                }
            },
            "/gordo/v0/openapi.json": {
                "get": {
                    "summary": "This document",
                    "responses": {"200": {"description": "OpenAPI 3.0 spec"}},
                }
            },
            "/healthcheck": {
                "get": {"summary": "Liveness probe",
                        "responses": {"200": {"description": "OK"}}}
            },
            "/readiness": {
                "get": {
                    "summary": "Readiness probe: 200 iff every "
                    "EXPECTED_MODELS artifact is present",
                    "responses": {
                        "200": {"description": "All expected models present"},
                        "503": {"description": "Build still in progress "
                                "(body lists missing models)"},
                    },
                }
            },
            "/server-version": {
                "get": {"summary": "Server version",
                        "responses": {"200": {"description": "{version}"}}}
            },
            "/debug/flight": {
                "get": {
                    "summary": "Flight recorder: tail-sampled request "
                    "traces as Chrome trace-event JSON (open in Perfetto); "
                    "gated by GORDO_TPU_DEBUG_ENDPOINTS",
                    "responses": {
                        "200": {"description": "Chrome trace-event JSON "
                                "with a gordoFlight summary sidecar"},
                        "404": {"description": "Debug endpoints disabled"},
                    },
                }
            },
            "/debug/vars": {
                "get": {
                    "summary": "Live telemetry-metric and serving-state "
                    "snapshot as JSON; gated by GORDO_TPU_DEBUG_ENDPOINTS",
                    "responses": {
                        "200": {"description": "{metrics, server, batcher, "
                                "flight}"},
                        "404": {"description": "Debug endpoints disabled"},
                    },
                }
            },
            "/debug/config": {
                "get": {
                    "summary": "Resolved GORDO_TPU_* knob values (secrets "
                    "redacted); gated by GORDO_TPU_DEBUG_ENDPOINTS",
                    "responses": {
                        "200": {"description": "{env, resolved}"},
                        "404": {"description": "Debug endpoints disabled"},
                    },
                }
            },
            "/debug/slo": {
                "get": {
                    "summary": "Per-model rolling-window SLO summaries and "
                    "burn rates (local + fleet-merged when telemetry "
                    "shards are on); gated by GORDO_TPU_DEBUG_ENDPOINTS",
                    "responses": {
                        "200": {"description": "{local, fleet}"},
                        "404": {"description": "Debug endpoints disabled"},
                    },
                }
            },
            "/debug/drift": {
                "get": {
                    "summary": "Per-model drift-detector state — baseline, "
                    "CUSUM score, status, rolling error windows — local "
                    "and fleet-merged, plus rebuild-queue depth; gated by "
                    "GORDO_TPU_DEBUG_ENDPOINTS",
                    "responses": {
                        "200": {"description": "{enabled, local, fleet, "
                                "queue}"},
                        "404": {"description": "Debug endpoints disabled"},
                    },
                }
            },
            "/debug/profile": {
                "get": {
                    "summary": "Sampling profiler: burst-capture the "
                    "registered hot threads for ?seconds=N (&hz= "
                    "overrides the rate) and return collapsed stacks "
                    "(&format=collapsed|chrome|json); &steady=1 returns "
                    "the steady sampler's accumulated view, &device=1 "
                    "runs a jax.profiler device trace; gated by "
                    "GORDO_TPU_DEBUG_ENDPOINTS",
                    "responses": {
                        "200": {"description": "Collapsed-stack text, "
                                "Chrome trace JSON, or sample summary"},
                        "404": {"description": "Debug endpoints disabled"},
                    },
                }
            },
            "/debug/perf": {
                "get": {
                    "summary": "Latency attribution: per-phase window "
                    "quantiles, the live p50/p99 decomposition against "
                    "the previous window (with mix-shift term), and the "
                    "perf-regression sentinel's per-phase CUSUM state; "
                    "gated by GORDO_TPU_DEBUG_ENDPOINTS",
                    "responses": {
                        "200": {"description": "{attribution, sentinel}"},
                        "404": {"description": "Debug endpoints disabled"},
                    },
                }
            },
            "/debug/prewarm": {
                "post": {
                    "summary": "Warm the serving caches for one machine "
                    "(?machine=<name>) or the whole collection — "
                    "optionally a specific revision (&revision=<rev>, the "
                    "hot-swap cutover pre-warm): program compile, "
                    "param-bank pin, AOT pre-lower — the gateway's "
                    "successor pre-warm hook; gated by "
                    "GORDO_TPU_DEBUG_ENDPOINTS",
                    "responses": {
                        "200": {"description": "Warmup summary JSON"},
                        "404": {"description": "Debug endpoints disabled"},
                        "409": {"description": "No model collection "
                                "configured"},
                    },
                }
            },
            "/metrics": {
                "get": {"summary": "Prometheus metrics (when enabled), or "
                        "the merged fleet exposition when telemetry shards "
                        "are on (GORDO_TPU_TELEMETRY_DIR) — no "
                        "prometheus_client required",
                        "responses": {"200": {"description": "text format"},
                                      "404": {"description": "disabled"}}}
            },
        },
    }
