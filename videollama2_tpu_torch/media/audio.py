"""Audio front end of the PyTorch port: Kaldi-compatible log-mel filterbank
features for BEATs (VideoLLaMA2.1-AV's audio tower).

The port's own copy of the JAX package's `media/audio.py` (numpy only, on
the host), held equal to the original by tests/test_torch_config.py and
tests/test_torch_audio.py: the reference feeds BEATs with
`torchaudio.compliance.kaldi.fbank(wav * 2**15, num_mel_bins=128)`, here
computed directly:

  snip-edges framing (25 ms window / 10 ms shift), DC removal, pre-emphasis
  0.97, povey window, 512-point rFFT power spectrum, 128 Kaldi-style mel
  triangles over [20 Hz, Nyquist], natural log with float eps floor.

`.wav` files are read with the stdlib `wave` module; the audio tracks of
other containers go through the port's C++ decoder (media/video_reader.py),
which raises RuntimeError on a host where it cannot be built.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000
FRAME_LENGTH_MS = 25.0
FRAME_SHIFT_MS = 10.0
NUM_MEL_BINS = 128
LOW_FREQ = 20.0
PREEMPH = 0.97
# BEATs normalization constants (BEATs.preprocess)
FBANK_MEAN = 15.41663
FBANK_STD = 6.55582


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _povey_window(n: int) -> np.ndarray:
    i = np.arange(n)
    return (0.5 - 0.5 * np.cos(2 * np.pi * i / (n - 1))) ** 0.85


def _mel(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq) / 700.0)


def mel_banks(num_bins: int, fft_size: int, sample_rate: float,
              low_freq: float = LOW_FREQ,
              high_freq: float = 0.0) -> np.ndarray:
    """Kaldi MelBanks: [num_bins, fft_size//2 + 1] triangle weights."""
    if high_freq <= 0.0:
        high_freq = sample_rate / 2 + high_freq
    num_fft_bins = fft_size // 2
    fft_bin_width = sample_rate / fft_size
    mel_low = _mel(low_freq)
    mel_high = _mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bins = np.zeros((num_bins, num_fft_bins + 1), np.float32)
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = mel_low + (b + 1) * mel_delta
        right = mel_low + (b + 2) * mel_delta
        for i in range(num_fft_bins):  # kaldi omits the nyquist bin
            m = _mel(fft_bin_width * i)
            if left < m < right:
                if m <= center:
                    bins[b, i] = (m - left) / (center - left)
                else:
                    bins[b, i] = (right - m) / (right - center)
    return bins


_BANK_CACHE: dict = {}


def fbank(waveform: np.ndarray, sample_rate: int = SAMPLE_RATE,
          num_mel_bins: int = NUM_MEL_BINS) -> np.ndarray:
    """waveform: [num_samples] float in [-1, 1] -> [num_frames, num_mel_bins].

    torchaudio.compliance.kaldi.fbank's defaults, with the BEATs int16
    scaling applied here (wav * 2**15).
    """
    wav = np.asarray(waveform, np.float64) * (2 ** 15)
    window_size = int(sample_rate * FRAME_LENGTH_MS / 1000)
    shift = int(sample_rate * FRAME_SHIFT_MS / 1000)
    fft_size = _next_pow2(window_size)
    if len(wav) < window_size:
        return np.zeros((0, num_mel_bins), np.float32)
    num_frames = 1 + (len(wav) - window_size) // shift

    idx = (np.arange(num_frames)[:, None] * shift
           + np.arange(window_size)[None, :])
    frames = wav[idx]                                     # [F, W]
    frames = frames - frames.mean(axis=1, keepdims=True)  # remove DC
    # pre-emphasis (kaldi: x[i] -= 0.97 * x[i-1], x[-1] edge-replicated)
    prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
    frames = frames - PREEMPH * prev
    frames = frames * _povey_window(window_size)

    padded = np.zeros((num_frames, fft_size))
    padded[:, :window_size] = frames
    spec = np.fft.rfft(padded, axis=1)
    power = np.abs(spec) ** 2                             # [F, fft/2+1]

    key = (num_mel_bins, fft_size, sample_rate)
    if key not in _BANK_CACHE:
        _BANK_CACHE[key] = mel_banks(num_mel_bins, fft_size, sample_rate)
    banks = _BANK_CACHE[key]
    mel = power[:, :banks.shape[1]] @ banks.T
    mel = np.log(np.maximum(mel, np.finfo(np.float32).eps))
    return mel.astype(np.float32)


def beats_preprocess(waveform: np.ndarray,
                     sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """BEATs input normalization: (fbank - mean) / (2 * std)."""
    fb = fbank(waveform, sample_rate)
    return (fb - FBANK_MEAN) / (2 * FBANK_STD)


def load_audio(path: str) -> np.ndarray:
    """A 16 kHz mono waveform from a .wav file (the stdlib reader below) or
    from a video container's own audio track (the VideoLLaMA2.1-AV input,
    reference README.md:130-132), through the C++ decoder
    (media/video_reader.decode_audio)."""
    if path.lower().endswith(".wav"):
        return load_wav(path)
    from . import video_reader
    return video_reader.decode_audio(path, SAMPLE_RATE)


def load_wav(path: str):
    """Minimal WAV reader (stdlib); resampling to 16 kHz by linear interp."""
    import wave
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    data = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    if width == 1:
        data = (data - 128.0) / 128.0
    else:
        data = data / float(2 ** (8 * width - 1))
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    if sr != SAMPLE_RATE:
        t_old = np.arange(len(data)) / sr
        t_new = np.arange(int(len(data) * SAMPLE_RATE / sr)) / SAMPLE_RATE
        data = np.interp(t_new, t_old, data).astype(np.float32)
    return data
