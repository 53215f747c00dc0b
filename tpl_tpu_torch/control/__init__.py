from tpl_tpu_torch.control.base_controller import BaseController
from tpl_tpu_torch.control.const_acc_controller import ConstAccController
from tpl_tpu_torch.control.direct_controller import DirectController
from tpl_tpu_torch.control.model_predictive_controller import (
    ModelPredictiveController,
)
from tpl_tpu_torch.control.model_predictive_controller_time import (
    ModelPredictiveControllerTime,
)
from tpl_tpu_torch.control.feedforward_controller import FeedforwardController
from tpl_tpu_torch.control.flat_controller import FlatController
