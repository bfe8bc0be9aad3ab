"""Media export: decoded frames and waveforms -> GIF, WAV and muxed AV
files (the port's own copy of owl_audio_exps_tpu/utils/media.py, host
code on numpy, PIL and scipy; the paths the trainers' exports use).

GIF frames go through PIL, WAV through scipy; ``write_av`` muxes one
watchable file: mp4 + AAC through an ffmpeg subprocess when the binary
exists, else the pure-Python MJPEG + PCM AVI of ``write_avi``.
``channel_gifs`` shows latent channels; ``wandb_video`` / ``wandb_audio``
wrap media for wandb where it is installed.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def to_uint8_frames(video: np.ndarray) -> np.ndarray:
    """[n, H, W, 3] float in [-1, 1] -> uint8."""
    v = np.clip((np.asarray(video, dtype=np.float32) + 1.0) * 127.5, 0, 255)
    return v.astype(np.uint8)


def write_gif(path: str, frames: np.ndarray, fps: int = 60) -> str:
    """frames: [n, H, W, 3] uint8 (reference gif grids:
    owl_wms/utils/logging.py:83-94 use fps=60)."""
    from PIL import Image
    imgs = [Image.fromarray(f) for f in frames]
    duration_ms = max(int(1000 / fps), 20)  # GIF timing granularity
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=duration_ms, loop=0)
    return path


def write_wav(path: str, waveform: np.ndarray, sample_rate: int = 44100
              ) -> str:
    """waveform: [n_samples, channels] float in [-1, 1]; stereo 44.1 kHz
    is the reference audio format (BASELINE.md)."""
    from scipy.io import wavfile
    wf = np.clip(np.asarray(waveform, dtype=np.float32), -1.0, 1.0)
    wavfile.write(path, sample_rate, (wf * 32767).astype(np.int16))
    return path


def channel_gifs(latents: np.ndarray, out_dir: str, prefix: str,
                 channels: Sequence[int] = (0,), fps: int = 60):
    """One grey GIF per channel of a latent video [n, c, h, w], each
    scaled to its own min and max: ``<prefix>_ch<k>.gif``."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for ch in channels:
        x = np.asarray(latents[:, ch], dtype=np.float32)
        lo, hi = x.min(), x.max()
        norm = (x - lo) / max(hi - lo, 1e-6)
        frames = (np.repeat(norm[..., None], 3, axis=-1) * 255).astype(
            np.uint8)
        paths.append(write_gif(
            os.path.join(out_dir, f"{prefix}_ch{ch}.gif"), frames, fps))
    return paths


def _jpeg_bytes(frame: np.ndarray, quality: int = 90) -> bytes:
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_avi(path: str, frames: np.ndarray, waveform: np.ndarray = None,
              fps: int = 60, sample_rate: int = 44100,
              quality: int = 90) -> str:
    """Single watchable AV artifact via a pure-python RIFF/AVI muxer:
    MJPEG video + interleaved PCM16 audio. No ffmpeg/moviepy needed —
    the muxed analogue of the reference's to_wandb_av mp4+AAC artifact
    (owl_wms/utils/logging.py:96-143) for this image's toolset.

    frames: [n, H, W, 3] uint8; waveform: [n_samples, channels] float
    in [-1, 1] (or None for video-only).
    """
    import struct

    n, H, W = frames.shape[:3]
    has_audio = waveform is not None and len(waveform) > 0
    if has_audio:
        wf = np.clip(np.asarray(waveform, dtype=np.float32), -1, 1)
        if wf.ndim == 1:
            wf = wf[:, None]
        pcm = (wf * 32767).astype("<i2")
        n_ch = pcm.shape[1]
        block_align = 2 * n_ch
        bytes_per_sec = sample_rate * block_align
        # samples interleaved per video frame (reference: 735 @ 60fps)
        split = np.linspace(0, len(pcm), n + 1).astype(int)

    jpegs = [_jpeg_bytes(f, quality) for f in frames]
    max_jpeg = max(len(j) for j in jpegs)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(kind: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", kind + payload)

    # --- stream headers
    avih = struct.pack(
        "<IIIIIIIIIIIIII",
        int(1e6 / fps), max_jpeg * fps, 0, 0x10,  # AVIF_HASINDEX
        n, 0, 2 if has_audio else 1, max_jpeg, W, H, 0, 0, 0, 0)
    strh_v = struct.pack(
        "<4s4sIHHIIIIIIII4H",
        b"vids", b"MJPG", 0, 0, 0, 0, 1, fps, 0, n, max_jpeg,
        0xFFFFFFFF, 0, 0, 0, W, H)
    strf_v = struct.pack("<IiiHH4sIiiII", 40, W, H, 1, 24, b"MJPG",
                         W * H * 3, 0, 0, 0, 0)
    hdrl = chunk(b"avih", avih) + lst(
        b"strl", chunk(b"strh", strh_v) + chunk(b"strf", strf_v))
    if has_audio:
        strh_a = struct.pack(
            "<4s4sIHHIIIIIIII4H",
            b"auds", b"\x00\x00\x00\x00", 0, 0, 0, 0,
            block_align, bytes_per_sec, 0, len(pcm), bytes_per_sec,
            0xFFFFFFFF, block_align, 0, 0, 0, 0)
        strf_a = struct.pack("<HHIIHH", 1, n_ch, sample_rate,
                             bytes_per_sec, block_align, 16)
        hdrl += lst(b"strl", chunk(b"strh", strh_a) + chunk(b"strf", strf_a))

    # --- movi: interleave 00dc / 01wb per frame, build idx1 as we go
    movi_parts = []
    idx = []
    offset = 4  # relative to the first byte of 'movi'
    for i in range(n):
        vch = chunk(b"00dc", jpegs[i])
        idx.append((b"00dc", 0x10, offset, len(jpegs[i])))
        movi_parts.append(vch)
        offset += len(vch)
        if has_audio:
            seg = pcm[split[i]:split[i + 1]].tobytes()
            ach = chunk(b"01wb", seg)
            idx.append((b"01wb", 0x10, offset, len(seg)))
            movi_parts.append(ach)
            offset += len(ach)
    movi = lst(b"movi", b"".join(movi_parts))

    idx1 = chunk(b"idx1", b"".join(
        f + struct.pack("<III", fl, off, sz) for f, fl, off, sz in idx))

    body = b"AVI " + lst(b"hdrl", hdrl) + movi + idx1
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def write_mp4_ffmpeg(path: str, frames: np.ndarray,
                     waveform: np.ndarray = None, fps: int = 60,
                     sample_rate: int = 44100) -> Optional[str]:
    """mp4 + AAC via an ffmpeg subprocess when the binary exists
    (the reference's exact artifact, owl_wms/utils/logging.py:96-143);
    returns None when ffmpeg is unavailable so callers fall back to
    ``write_avi``."""
    import shutil
    import subprocess
    import tempfile

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        return None
    n, H, W = frames.shape[:3]
    with tempfile.TemporaryDirectory() as td:
        raw = os.path.join(td, "frames.rgb")
        with open(raw, "wb") as fh:
            fh.write(np.ascontiguousarray(frames).tobytes())
        cmd = [ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
               "-s", f"{W}x{H}", "-r", str(fps), "-i", raw]
        if waveform is not None:
            wav = os.path.join(td, "audio.wav")
            write_wav(wav, waveform, sample_rate)
            cmd += ["-i", wav, "-c:a", "aac", "-shortest"]
        cmd += ["-c:v", "libx264", "-pix_fmt", "yuv420p", path]
        res = subprocess.run(cmd, capture_output=True)
        if res.returncode != 0:
            return None
    return path


def write_av(path_base: str, frames: np.ndarray,
             waveform: np.ndarray = None, fps: int = 60,
             sample_rate: int = 44100) -> str:
    """One muxed AV file: mp4+AAC if ffmpeg exists, else the pure-python
    MJPEG+PCM AVI."""
    out = write_mp4_ffmpeg(path_base + ".mp4", frames, waveform, fps,
                           sample_rate)
    if out is not None:
        return out
    return write_avi(path_base + ".avi", frames, waveform, fps, sample_rate)


def save_av_bundle(out_dir: str, name: str, video_frames: np.ndarray = None,
                   waveform: np.ndarray = None,
                   mouse: np.ndarray = None, buttons: np.ndarray = None,
                   fps: int = 60, sample_rate: int = 44100):
    """Joint AV export with optional control overlays — the offline
    analogue of to_wandb_av (owl_wms/utils/logging.py:96-143). When both
    video and audio are present they additionally land in ONE muxed,
    watchable file (mp4+AAC via ffmpeg when available, else the
    pure-python MJPEG+PCM AVI)."""
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    frames = None
    if video_frames is not None:
        frames = to_uint8_frames(video_frames)
        if mouse is not None and buttons is not None:
            from .vis import draw_frames
            frames = draw_frames(frames, np.asarray(mouse),
                                 np.asarray(buttons))
        written["video"] = write_gif(
            os.path.join(out_dir, f"{name}.gif"), frames, fps)
    if waveform is not None:
        written["audio"] = write_wav(
            os.path.join(out_dir, f"{name}.wav"), waveform, sample_rate)
    if frames is not None and waveform is not None:
        written["av"] = write_av(os.path.join(out_dir, name), frames,
                                 waveform, fps, sample_rate)
    return written


def wandb_video(video_frames: np.ndarray, fps: int = 60):
    """A ``wandb.Video`` of frames [n, H, W, 3] in [-1, 1] when wandb is
    installed, else the frames as they are."""
    try:
        import wandb
    except ImportError:
        return video_frames
    frames = to_uint8_frames(video_frames)
    return wandb.Video(np.transpose(frames, (0, 3, 1, 2)), fps=fps)


def wandb_audio(waveform: np.ndarray, sample_rate: int = 44100):
    """A ``wandb.Audio`` of a waveform when wandb is installed, else the
    waveform as it is."""
    try:
        import wandb
    except ImportError:
        return waveform
    return wandb.Audio(np.asarray(waveform, dtype=np.float32),
                       sample_rate=sample_rate)
