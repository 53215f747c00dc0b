from tpl_tpu_torch.simulation.state import (
    SimState,
    SimCar,
    SimEgo,
    SimTrafficLight,
    SimTimeConstraint,
    SimSettings,
    SimRuleViolation,
    SimRuleChecker,
    SimIdmParams,
    load_sim_state,
    save_sim_state,
)
from tpl_tpu_torch.simulation.core import SimCore, ScenarioLoadError
from tpl_tpu_torch.simulation.standalone import SimStandalone
