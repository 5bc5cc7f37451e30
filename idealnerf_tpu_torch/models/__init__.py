from idealnerf_tpu_torch.models.audio_net import (
    AudioAttNet, AudioNet, DeepSpeechAudNet,
)
from idealnerf_tpu_torch.models.face_nerf import (
    FaceNeRF, FaceNeRFConfig, apply_face_nerf, apply_folded, fold_conditioning,
)

__all__ = [
    "AudioAttNet", "AudioNet", "DeepSpeechAudNet", "FaceNeRF",
    "FaceNeRFConfig", "apply_face_nerf", "apply_folded", "fold_conditioning",
]
