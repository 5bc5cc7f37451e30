"""Offline data-production pipeline (counterpart of pipeline/; reference:
data_util/ — SURVEY.md §2.6): DeepSpeech audio features
(``audio``, ``deepspeech``), the FAN landmark network (``fan``), BiSeNet
parsing (``parsing_net``), background-plate extraction, head/composite
image decoupling and the transforms_exp_*.json writer (``process``), and
3DMM head tracking (``tracking``). ``cli/process_data.py`` drives them.
"""

from idealnerf_tpu_torch.pipeline.audio import (
    mfcc, deepspeech_input_vector, interpolate_features,
    make_audio_windows, extract_deepspeech_features,
)
from idealnerf_tpu_torch.pipeline.deepspeech import (
    deepspeech_logits, load_params as load_deepspeech_params,
    make_logits_fn, make_logits_fn_from_graph, random_params
    as random_deepspeech_params,
)
from idealnerf_tpu_torch.pipeline.process import (
    extract_background_plate, decouple_images, write_transforms,
    parse_color_map,
)
