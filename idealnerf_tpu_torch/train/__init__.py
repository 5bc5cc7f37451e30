from idealnerf_tpu_torch.train.head import (
    HeadTrainer, compute_aud_feature, make_frame_loss, make_head_train_step,
)
from idealnerf_tpu_torch.train.state import (
    ModelState, TrainState, init_params, init_train_state, make_optimizer,
)

__all__ = ["HeadTrainer", "ModelState", "TrainState", "compute_aud_feature",
           "init_params", "init_train_state", "make_frame_loss",
           "make_head_train_step", "make_optimizer"]
