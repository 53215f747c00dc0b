from tpl_tpu_torch.control.base_controller import BaseController
from tpl_tpu_torch.control.const_acc_controller import ConstAccController
from tpl_tpu_torch.control.model_predictive_controller import (
    ModelPredictiveController,
)
