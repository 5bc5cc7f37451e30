"""DeepSpeech-style audio feature extraction (counterpart of
pipeline/audio.py, which is numpy: this is a copy, not an import;
reference: data_util/deepspeech_features/deepspeech_features.py).

Pipeline parity: resample to 16 kHz → MFCC (26 cepstra, 25 ms window,
10 ms step, python_speech_features defaults) → BiRNN stride-2 subsample →
±9-frame context windows, globally standardized (:185-239) → acoustic
model logits (29-dim) → linear interpolation from 50 fps to video fps
(:241-275) → zero-padded sliding win_size=16 windows (:169-180) →
``aud.npy`` of shape (num_frames, 16, 29).

The acoustic model is pluggable (``logits_fn``): ``pipeline/deepspeech.py``
runs the frozen DeepSpeech graph without TensorFlow. The default fallback
is a fixed random projection of the normalized MFCC context vectors to 29
channels — deterministic, audio-dependent, clearly NOT DeepSpeech phoneme
logits, but it keeps the full pipeline runnable and trainable end-to-end
(the conditioning encoder learns whatever consistent acoustic features it
is given).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


# ------------------------------------------------------------------- MFCC

def _mel(hz):
    return 2595.0 * np.log10(1.0 + hz / 700.0)


def _mel_inv(mel):
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


def mfcc(
    signal: np.ndarray,
    samplerate: int = 16000,
    numcep: int = 26,
    winlen: float = 0.025,
    winstep: float = 0.01,
    nfilt: int = 26,
    nfft: int = 512,
    preemph: float = 0.97,
    ceplifter: int = 22,
    append_energy: bool = True,
) -> np.ndarray:
    """python_speech_features-compatible MFCC (rectangular window,
    replace-c0-with-log-energy) — the exact front-end DeepSpeech 0.1.0
    expects."""
    signal = np.asarray(signal, np.float64)
    signal = np.append(signal[0], signal[1:] - preemph * signal[:-1])

    frame_len = int(round(winlen * samplerate))
    frame_step = int(round(winstep * samplerate))
    n = len(signal)
    num_frames = 1 if n <= frame_len else 1 + int(
        np.ceil((n - frame_len) / frame_step)
    )
    pad = (num_frames - 1) * frame_step + frame_len - n
    padded = np.concatenate([signal, np.zeros(pad)])
    idx = (
        np.tile(np.arange(frame_len), (num_frames, 1))
        + np.tile(np.arange(0, num_frames * frame_step, frame_step), (frame_len, 1)).T
    )
    frames = padded[idx]

    mag = np.absolute(np.fft.rfft(frames, nfft))
    pspec = (1.0 / nfft) * (mag**2)
    energy = np.sum(pspec, 1)
    energy = np.where(energy == 0, np.finfo(np.float64).eps, energy)

    highfreq = samplerate / 2
    mel_pts = np.linspace(_mel(0), _mel(highfreq), nfilt + 2)
    bins = np.floor((nfft + 1) * _mel_inv(mel_pts) / samplerate).astype(int)
    fbank = np.zeros((nfilt, nfft // 2 + 1))
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fbank[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(bins[j + 1], bins[j + 2]):
            fbank[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])

    feat = pspec @ fbank.T
    feat = np.where(feat == 0, np.finfo(np.float64).eps, feat)
    feat = np.log(feat)

    from scipy.fftpack import dct

    feat = dct(feat, type=2, axis=1, norm="ortho")[:, :numcep]
    if ceplifter > 0:
        lift = 1 + (ceplifter / 2.0) * np.sin(
            np.pi * np.arange(numcep) / ceplifter
        )
        feat = feat * lift
    if append_energy:
        feat[:, 0] = np.log(energy)
    return feat


# ------------------------------------------------- DeepSpeech input vector

def deepspeech_input_vector(
    audio: np.ndarray, sample_rate: int = 16000,
    num_cepstrum: int = 26, num_context: int = 9,
) -> np.ndarray:
    """(T, (2·context+1)·numcep) standardized context windows
    (deepspeech_features.py:185-239)."""
    features = mfcc(audio, samplerate=sample_rate, numcep=num_cepstrum)
    features = features[::2]  # BiRNN stride
    num_strides = len(features)
    empty = np.zeros((num_context, num_cepstrum), features.dtype)
    features = np.concatenate([empty, features, empty])
    window = 2 * num_context + 1
    out = np.stack([features[i : i + window] for i in range(num_strides)])
    out = out.reshape(num_strides, -1)
    return (out - np.mean(out)) / max(np.std(out), 1e-12)


def interpolate_features(features: np.ndarray, input_rate: float,
                         output_rate: float, output_len: int) -> np.ndarray:
    """Per-channel linear resample in time (deepspeech_features.py:241-275,
    vectorized)."""
    t_in = np.arange(features.shape[0]) / float(input_rate)
    t_out = np.arange(output_len) / float(output_rate)
    return np.stack(
        [np.interp(t_out, t_in, features[:, c]) for c in range(features.shape[1])],
        axis=1,
    )


def make_audio_windows(logits: np.ndarray, win_size: int = 16,
                       stride: int = 1) -> np.ndarray:
    """Zero-padded sliding windows (deepspeech_features.py:169-180):
    (T, C) -> (N, win_size, C)."""
    zero = np.zeros((win_size // 2, logits.shape[1]))
    padded = np.concatenate([zero, logits, zero])
    return np.stack(
        [padded[i : i + win_size]
         for i in range(0, padded.shape[0] - win_size, stride)]
    )


def _fallback_logits_fn(seed: int = 0) -> Callable:
    """Deterministic 29-dim projection of the MFCC context vectors (the
    no-TF stand-in; see module docstring)."""
    def fn(input_vector: np.ndarray) -> np.ndarray:
        rng = np.random.RandomState(seed)
        proj = rng.randn(input_vector.shape[1], 29) / np.sqrt(input_vector.shape[1])
        return np.tanh(input_vector @ proj)

    return fn


def extract_deepspeech_features(
    audio: np.ndarray,
    sample_rate: int,
    num_frames: Optional[int] = None,
    win_size: int = 16,
    logits_fn: Optional[Callable] = None,
) -> np.ndarray:
    """Full chain: raw audio -> (num_frames, win_size, 29) aud windows.

    ``logits_fn(input_vector (T, 494)) -> (T, 29)``: plug the real
    DeepSpeech acoustic model here when its graph is available."""
    target_sr = 16000
    if sample_rate != target_sr:
        t_in = np.arange(len(audio)) / sample_rate
        n_out = int(round(len(audio) * target_sr / sample_rate))
        t_out = np.arange(n_out) / target_sr
        audio = np.interp(t_out, t_in, audio.astype(np.float64))
        sample_rate = target_sr

    vec = deepspeech_input_vector(audio.astype(np.float64), sample_rate)
    logits = (logits_fn or _fallback_logits_fn())(vec)

    deepspeech_fps = 50.0
    audio_len_s = len(audio) / float(sample_rate)
    if num_frames is None:
        video_fps = 25.0
        num_frames = int(round(audio_len_s * video_fps))
    else:
        video_fps = num_frames / audio_len_s
    logits = interpolate_features(logits, deepspeech_fps, video_fps, num_frames)
    windows = make_audio_windows(logits, win_size=win_size, stride=1)
    return windows[:num_frames].astype(np.float32)
