"""
Chaos conductor, the port's copy of ``gordo_tpu/chaos``: declarative
failure-drill scenarios against a real gateway and fleet serving stack.

A scenario file (JSON, see chaos/scenarios/) describes one drill: the
stack to spin up (N serving nodes and one gateway), a timeline of shaped
load phases (chaos/load.py schedules), fault actions
fired at offsets into the run (kill/SIGSTOP a node, expire or corrupt a
membership lease, plus any ``GORDO_TPU_FAULT_PLAN`` rule for the
in-process fault sites), and machine-checked invariants evaluated from
the merged response log and telemetry afterwards.

The pieces:

- :mod:`~gordo_tpu_torch.chaos.scenario`: the schema, vocabulary and parser;
- :mod:`~gordo_tpu_torch.chaos.load`: the shaped schedules, key picker,
  open-loop driver and chaff;
- :mod:`~gordo_tpu_torch.chaos.node`: the serving-node subprocess
  (``python -m gordo_tpu_torch.chaos.node``): a membership lease,
  per-model circuit breakers and the serving fault sites, no model stack
  and no CUDA, so kills and stops are OS signals against a real lease
  holder;
- :mod:`~gordo_tpu_torch.chaos.stack`: spins the fleet up and aims actions;
- :mod:`~gordo_tpu_torch.chaos.invariants`: the checkers;
- :mod:`~gordo_tpu_torch.chaos.conductor`: runs the timeline and writes the
  report. CLI: ``python -m gordo_tpu_torch chaos run <scenario>``.

Every knob defaults off: importing or not running a scenario changes
nothing about serving.
"""

from .conductor import run_scenario  # noqa: F401
from .scenario import Scenario, load_scenario  # noqa: F401
