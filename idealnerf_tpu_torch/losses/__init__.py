"""The second stage's aux losses (counterpart of losses/): FAN landmark,
VGG16 and VGGFace perceptual terms, and the pixel metrics."""

from idealnerf_tpu_torch.losses.landmark import (
    LandmarkLoss, heatmap_landmark_loss, landmark_feature_loss,
    landmark_features,
)
from idealnerf_tpu_torch.losses.perceptual import (
    FeatureLoss, gram_matrix, make_vgg16_features,
)
from idealnerf_tpu_torch.losses.vgg import (
    VGG16, VGGFace, init_vgg16, init_vggface, load_vggface, make_vgg16_loss,
    make_vggface_loss, vgg16_features, vggface_features,
)
from idealnerf_tpu_torch.utils.metrics import img2mse, mse2psnr

__all__ = ["FeatureLoss", "LandmarkLoss", "VGG16", "VGGFace",
           "gram_matrix", "heatmap_landmark_loss", "img2mse", "init_vgg16",
           "init_vggface", "landmark_feature_loss", "landmark_features",
           "load_vggface", "make_vgg16_features", "make_vgg16_loss",
           "make_vggface_loss", "mse2psnr", "vgg16_features",
           "vggface_features"]
