"""3DMM head-pose tracking (counterpart of pipeline/tracking/; reference:
data_util/face_tracking/): Adam over Basel-Face-Model-style linear
blendshapes on the model's device. The landmark stages (focal grid
search, global identity/pose fit, refinement with temporal Laplacian
smoothing) and the photometric stages (initial texture/lighting fit and
the sliding-window refinement, through the tile-binned differentiable
soft rasterizer in ``rasterizer.py``: pytorch3d-equivalent softmax
blending and SH-9 illumination) are plain torch ops."""

from idealnerf_tpu_torch.pipeline.tracking.geometry import (
    euler2rot, euler2rot_np, rot_trans_pts, proj_pts, forward_transform,
    lap_loss, landmark_loss, compute_tri_normal,
)
from idealnerf_tpu_torch.pipeline.tracking.facemodel import Face3DMM
from idealnerf_tpu_torch.pipeline.tracking.rasterizer import (
    RasterConfig, Render3DMM, compute_vertex_normals, rasterize_soft,
    sh9_illumination,
)
from idealnerf_tpu_torch.pipeline.tracking.tracker import (
    FaceTracker, TrackResult, masked_color_loss,
)
