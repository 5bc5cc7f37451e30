"""Multi-device training and rendering (counterpart of parallel/).

The JAX package shards one program over a ('data', 'ray') mesh with
GSPMD. Here each device of the layout is a rank of ``torch.distributed``
(``launch`` starts them, one process each): frames of a step go over
'data', each frame's rays over 'ray', parameters and optimizer state are
replicated, and the ranks meet in ``all_reduce`` (``sharded``).
"""

from idealnerf_tpu_torch.parallel.launch import launch, mesh_shape
from idealnerf_tpu_torch.parallel.mesh import Mesh, make_mesh
from idealnerf_tpu_torch.parallel.sharded import (
    make_sharded_composite_renderer, make_sharded_composite_video_renderer,
    make_sharded_frame_renderer, make_sharded_torso_train_step,
    make_sharded_train_step, make_sharded_video_renderer,
)
from idealnerf_tpu_torch.parallel.trainers import (
    ShardedHeadTrainer, ShardedTorsoTrainer,
)
