"""Fleet autopilot: the closed control loop over the elastic fleet (the
port's copy of ``distlr_tpu/autopilot/``, stdlib only).

The actuators (``ps-ctl`` live resharding, the router's
ADDREPLICA/DELREPLICA, ``.claim`` worker elasticity) and the sensors
(fleet.json, windowed history, derived alert gauges) exist; this package
is the controller that connects them, split into a pure half and an
effectful half:

* :mod:`~distlr_tpu_torch.autopilot.policy`: the deterministic,
  clock-injected :class:`PolicyEngine` (bands, hysteresis, cooldowns,
  bounds, one-action-per-tick arbitration, rollback-on-alert);
* :mod:`~distlr_tpu_torch.autopilot.actuators`: the fleet-touching
  :class:`Actuators` (ps-ctl / router admin / worker subprocesses);
* :mod:`~distlr_tpu_torch.autopilot.daemon`: :class:`AutopilotDaemon`,
  the tick loop ``launch autopilot`` runs, journaling every decision to
  ``<run_dir>/autopilot/decisions.jsonl`` and exporting the
  ``distlr_autopilot_*`` series.
"""

from distlr_tpu_torch.autopilot.actuators import (
    ActuatorError,
    Actuators,
    EngineActuator,
    PSActuator,
    WorkerActuator,
)
from distlr_tpu_torch.autopilot.daemon import AutopilotDaemon, fleet_fetcher
from distlr_tpu_torch.autopilot.policy import (
    ACTUATORS,
    Action,
    Decision,
    FleetSignals,
    PolicyConfig,
    PolicyEngine,
)

__all__ = [
    "ACTUATORS",
    "Action",
    "ActuatorError",
    "Actuators",
    "AutopilotDaemon",
    "Decision",
    "EngineActuator",
    "FleetSignals",
    "PSActuator",
    "PolicyConfig",
    "PolicyEngine",
    "WorkerActuator",
    "fleet_fetcher",
]
