"""Wind-driven ambience: mixing law + procedural loop synthesis (C20).

The reference cross-fades two ambience loop assets (`ocean_loop.wav`,
`wind_loop.wav`) by total wind speed (main.gd:39-44): ocean volume rises and
wind-whistle volume falls as the summed cascade wind speed approaches
15 m/s. This module reproduces the *control law* exactly, and replaces the
binary assets with procedural equivalents: both loops are synthesized in the
frequency domain using only harmonics of the loop period, so they are
seamless by construction (sample[0] continues sample[-1] with no crossfade).

Host-side NumPy, as in the JAX package (`utils/audio.py`), of which this is a
copy: audio is an aux subsystem, not a card workload. `ambience_gains` also
takes the port's `CascadeParams` (its wind speeds are read to the host once).
"""
from __future__ import annotations

import wave

import numpy as np
import torch


def ambience_gains_db(total_wind_speed: float) -> tuple[float, float]:
    """(ocean_db, wind_db) for the summed wind speed across cascades."""
    t = min(total_wind_speed / 15.0, 1.0)
    ocean_db = -30.0 + (15.0 - (-30.0)) * t    # lerp(-30, 15, t)  main.gd:42
    wind_db = 5.0 + (-30.0 - 5.0) * t          # lerp(5, -30, t)   main.gd:43
    return ocean_db, wind_db


def db_to_linear(db: float) -> float:
    return float(10.0 ** (db / 20.0))


def ambience_gains(params) -> tuple[float, float]:
    """Linear gains from a CascadeParams stack (or anything with a
    `wind_speed` array)."""
    ws = params.wind_speed
    if isinstance(ws, torch.Tensor):
        ws = ws.detach().cpu().numpy()
    total = float(np.asarray(ws).sum())
    o, w = ambience_gains_db(total)
    return db_to_linear(o), db_to_linear(w)


# ---------------------------------------------------------------------------
# Procedural loop synthesis
# ---------------------------------------------------------------------------

def _periodic_noise(magnitude: np.ndarray, rng: np.random.Generator,
                    num_samples: int) -> np.ndarray:
    """Random-phase signal with the given one-sided magnitude envelope.

    Built from harmonics of 1/duration only, so the result tiles seamlessly.
    DC and (for even lengths) Nyquist bins are zeroed: they carry no phase
    freedom and a DC offset would pop on playback.
    """
    spec = magnitude.astype(np.complex128)
    phases = rng.uniform(0.0, 2.0 * np.pi, size=spec.shape)
    spec = spec * np.exp(1j * phases)
    spec[0] = 0.0
    if num_samples % 2 == 0:
        spec[-1] = 0.0
    x = np.fft.irfft(spec, n=num_samples)
    peak = np.max(np.abs(x))
    return x / peak if peak > 0 else x


def _loop_bins(duration_s: float, sample_rate: int) -> np.ndarray:
    n = int(round(duration_s * sample_rate))
    return np.fft.rfftfreq(n, d=1.0 / sample_rate)


def synthesize_ocean_loop(duration_s: float = 8.0, sample_rate: int = 22050,
                          seed: int = 1234) -> np.ndarray:
    """Broadband wash: ~1/f noise rolled off above ~1 kHz, with a slow swell
    modulation at two non-commensurate low harmonics so the loop breathes
    like surf instead of hissing statically.

    Stands in for the reference's ocean_loop.wav asset (main.gd:40-42 mixes
    it on the "Ocean" bus); returns float64 in [-1, 1].
    """
    n = int(round(duration_s * sample_rate))
    f = _loop_bins(duration_s, sample_rate)
    rng = np.random.default_rng(seed)
    mag = np.zeros_like(f)
    nz = f > 0
    mag[nz] = (1.0 / (20.0 + f[nz])) / (1.0 + (f[nz] / 1000.0) ** 4)
    x = _periodic_noise(mag, rng, n)
    # Swell envelope from harmonics of the loop (stays seamless): mean 1.
    t = np.arange(n) / sample_rate
    h1, h2 = 2, 3  # 0.25 Hz and 0.375 Hz at the 8 s default
    env = 1.0 + 0.35 * np.sin(2 * np.pi * h1 * t / duration_s) \
              + 0.2 * np.sin(2 * np.pi * h2 * t / duration_s + 1.3)
    x = x * env
    return x / np.max(np.abs(x))


def synthesize_wind_loop(duration_s: float = 8.0, sample_rate: int = 22050,
                         seed: int = 4321) -> np.ndarray:
    """Wind whistle: band-passed noise centered ~600 Hz with two sharper
    resonances (whistle partials) and a slow gust modulation.

    Stands in for wind_loop.wav (main.gd:43, "Wind" bus); returns float64.
    """
    n = int(round(duration_s * sample_rate))
    f = _loop_bins(duration_s, sample_rate)
    rng = np.random.default_rng(seed)

    def peak(center, width):
        return np.exp(-0.5 * ((f - center) / width) ** 2)

    mag = 0.8 * peak(600.0, 350.0) + 0.5 * peak(1100.0, 90.0) \
        + 0.3 * peak(1650.0, 70.0)
    x = _periodic_noise(mag, rng, n)
    t = np.arange(n) / sample_rate
    env = 1.0 + 0.45 * np.sin(2 * np.pi * 1 * t / duration_s) \
              + 0.25 * np.sin(2 * np.pi * 5 * t / duration_s + 0.7)
    x = x * env
    return x / np.max(np.abs(x))


def render_ambience(params, duration_s: float = 8.0,
                    sample_rate: int = 22050) -> np.ndarray:
    """Mixed ambience for a cascade stack: gain-weighted sum of the two
    procedural loops under the reference mix law, normalized only if the mix
    clips. The relative ocean/wind balance is exactly main.gd:39-44."""
    ocean = synthesize_ocean_loop(duration_s, sample_rate)
    wind = synthesize_wind_loop(duration_s, sample_rate)
    g_ocean, g_wind = ambience_gains(params)
    # The reference's dB range spans +15 dB; normalize the pair so the
    # louder possible stem sits at 0 dBFS before summing.
    ref = db_to_linear(15.0)
    mix = (g_ocean * ocean + g_wind * wind) / ref
    peak = np.max(np.abs(mix))
    return mix / peak if peak > 1.0 else mix


def wav_bytes(data: np.ndarray, sample_rate: int = 22050) -> bytes:
    """16-bit mono PCM WAV as bytes (stdlib `wave`; no audio deps) — the
    web viewer serves the ambience loops from memory."""
    import io

    clipped = np.clip(np.asarray(data, dtype=np.float64), -1.0, 1.0)
    pcm = (clipped * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def write_wav(path: str, data: np.ndarray, sample_rate: int = 22050) -> None:
    """16-bit mono PCM writer (stdlib `wave`; no audio deps)."""
    with open(path, "wb") as f:
        f.write(wav_bytes(data, sample_rate))
