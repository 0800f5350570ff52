"""Audio IO (the port's own copy): native WAV parsing + pluggable
compressed-container decode.

WAV (PCM 8/16/24/32-bit + float) is parsed natively — the zero-dependency
default — and resampling is a polyphase filter via scipy.  Compressed
containers (mp3/flac/ogg/mp4...) decode through the first available
backend: ``soundfile`` when importable, else an ``ffmpeg`` subprocess with
the reference's exact invocation semantics (``ffmpeg_read``, reference
training/flax/distil_whisper/pipeline.py:276: ``-ac 1 -f f32le -ar N``).
When neither exists the error names the sniffed codec and the missing
decoders instead of failing cryptically.
"""

from __future__ import annotations

import shutil
import struct
import subprocess
from typing import Optional, Tuple, Union

import numpy as np


def read_wav(data: Union[bytes, str]) -> Tuple[np.ndarray, int]:
    """Parse a WAV file (path or raw bytes) -> (float32 mono [-1, 1], rate)."""
    if isinstance(data, str):
        with open(data, "rb") as f:
            data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            audio_format, channels, rate, _, _, bits = struct.unpack(
                "<HHIIHH", body[:16])
            fmt = (audio_format, channels, rate, bits)
        elif chunk_id == b"data":
            samples = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or samples is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, channels, rate, bits = fmt

    if audio_format == 3 and bits == 32:          # IEEE float
        x = np.frombuffer(samples, "<f4").astype(np.float32)
    elif audio_format in (1, 0xFFFE):             # PCM (or extensible)
        if bits == 16:
            x = np.frombuffer(samples, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(samples, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            raw = np.frombuffer(samples, np.uint8).reshape(-1, 3)
            x = ((raw[:, 0].astype(np.int32))
                 | (raw[:, 1].astype(np.int32) << 8)
                 | (raw[:, 2].astype(np.int32) << 16))
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32)
            x /= float(1 << 23)
        elif bits == 8:
            x = (np.frombuffer(samples, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}")

    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return np.ascontiguousarray(x, np.float32), rate


def write_wav(path: str, audio: np.ndarray, rate: int,
              float32: bool = False) -> None:
    """Write mono audio as a WAV file: 16-bit PCM of float32 [-1, 1] (test
    fixtures, export), or with ``float32`` the samples as they are, IEEE
    float (format 3), which :func:`read_wav` returns bit for bit."""
    if float32:
        data = np.ascontiguousarray(audio, "<f4").tobytes()
        fmt, width = 3, 4
    else:
        pcm = np.clip(audio, -1.0, 1.0)
        data = (pcm * 32767.0).astype("<i2").tobytes()
        fmt, width = 1, 2
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, fmt, 1, rate, rate * width,
                                 width, 8 * width)
    hdr += b"data" + struct.pack("<I", len(data))
    with open(path, "wb") as f:
        f.write(hdr + data)


_MAGIC_CODECS = (
    (b"ID3", "mp3"), (b"\xff\xfb", "mp3"), (b"\xff\xf3", "mp3"),
    (b"\xff\xf2", "mp3"), (b"fLaC", "flac"), (b"OggS", "ogg"),
    (b"\x1aE\xdf\xa3", "webm/matroska"),
)


def _sniff_codec(data: bytes) -> str:
    for magic, name in _MAGIC_CODECS:
        if data[:len(magic)] == magic:
            return name
    if len(data) >= 12 and data[4:8] == b"ftyp":
        return "mp4/m4a"
    return "unknown"


def _soundfile_read(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """Decode via the soundfile library when importable (flac/ogg/...)."""
    try:
        import soundfile as sf  # optional — absent in minimal images
    except ImportError:
        return None
    import io as _io
    audio, rate = sf.read(_io.BytesIO(data), dtype="float32",
                          always_2d=True)
    return np.ascontiguousarray(audio.mean(axis=1), np.float32), int(rate)


def _ffmpeg_read(data: bytes, sampling_rate: int) -> Optional[np.ndarray]:
    """Decode any container via an ffmpeg subprocess — the reference's
    semantics (``ffmpeg_read``, reference pipeline.py:276): mono float32
    little-endian at ``sampling_rate`` on stdout, input on stdin."""
    if shutil.which("ffmpeg") is None:
        return None
    cmd = ["ffmpeg", "-i", "pipe:0", "-ac", "1", "-f", "f32le",
           "-ar", str(sampling_rate), "-hide_banner", "-loglevel", "error",
           "pipe:1"]
    proc = subprocess.run(cmd, input=data, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE)
    if proc.returncode != 0:
        raise ValueError("ffmpeg failed to decode audio: "
                         + proc.stderr.decode(errors="replace")[-500:])
    return np.frombuffer(proc.stdout, np.float32).copy()


def decode_audio(data: Union[bytes, str],
                 sampling_rate: int = 16000) -> Tuple[np.ndarray, int]:
    """Decode audio bytes/path of any container -> (float32 mono, rate).

    WAV is parsed natively (no subprocess); other containers go through
    soundfile or ffmpeg when available.  The returned rate may differ from
    ``sampling_rate`` (callers resample); the ffmpeg path already emits at
    ``sampling_rate``.
    """
    if isinstance(data, str):
        with open(data, "rb") as f:
            data = f.read()
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return read_wav(data)
    decoded = _soundfile_read(data)
    if decoded is not None:
        return decoded
    audio = _ffmpeg_read(data, sampling_rate)
    if audio is not None:
        return audio, sampling_rate
    codec = _sniff_codec(data)
    raise ValueError(
        f"cannot decode non-WAV audio (detected container: {codec}): "
        "neither the 'soundfile' package nor an 'ffmpeg' binary is "
        "available — install one, or transcode to WAV upstream")


def resample(audio: np.ndarray, orig_rate: int, target_rate: int) -> np.ndarray:
    """Polyphase resampling to ``target_rate`` (librosa-free)."""
    if orig_rate == target_rate:
        return audio.astype(np.float32)
    from math import gcd
    from scipy.signal import resample_poly
    g = gcd(orig_rate, target_rate)
    return resample_poly(audio, target_rate // g, orig_rate // g).astype(np.float32)


def load_audio(source, sampling_rate: int = 16000) -> np.ndarray:
    """Best-effort audio load -> float32 mono at ``sampling_rate``.

    Accepts: audio path/bytes (WAV native; mp3/flac/ogg/... via
    :func:`decode_audio`'s soundfile/ffmpeg backends when available), a
    numpy array (assumed already at rate), or an HF datasets-style dict
    {"array": ..., "sampling_rate": ...} / {"path": ...} / {"bytes": ...}.
    """
    if isinstance(source, dict):
        if "array" in source:
            return resample(np.asarray(source["array"], np.float32),
                            int(source.get("sampling_rate", sampling_rate)),
                            sampling_rate)
        if "bytes" in source and source["bytes"] is not None:
            audio, rate = decode_audio(source["bytes"], sampling_rate)
            return resample(audio, rate, sampling_rate)
        if "path" in source:
            audio, rate = decode_audio(source["path"], sampling_rate)
            return resample(audio, rate, sampling_rate)
        raise ValueError(f"cannot interpret audio dict with keys {source.keys()}")
    if isinstance(source, (bytes, str)):
        audio, rate = decode_audio(source, sampling_rate)
        return resample(audio, rate, sampling_rate)
    return np.asarray(source, np.float32)
