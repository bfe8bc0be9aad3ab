"""Synthetic data generators (the port's own copy of
owl_audio_exps_tpu/data/synthetic.py): deterministic random
latents/controls for benchmarks, smoke tests and CI, drawn from the same
``numpy.random.RandomState`` stream as the JAX package's, so both yield
identical batches.

data_ids: ``synthetic_latent`` (video [b,n,c,h,w] + mouse + buttons),
``synthetic_av`` (adds audio [b,n,c_a]), ``synthetic_mixed`` (the mixed
labelled/unlabelled AV quintuple [vid, audio, mouse, btn, has_controls],
matching the reference mixed collate order
owl_wms/data/s3_cod_latent_mixed.py:247-256 — unlabelled rows get zeroed
controls), ``synthetic_audio_latent`` ([b,n,c]), ``synthetic_waveform``
([b,n_samples,2]).
"""

from __future__ import annotations

import numpy as np


def _tone_batch(full, rs):
    """LEARNABLE stereo audio: random sums of sinusoids (3-6 partials,
    80-6000 Hz at 44.1 kHz, random phases/amps, light noise floor).
    Unlike the white-noise ``synthetic_waveform`` source this has
    structure a conv VAE can actually reconstruct — the quality-anchor
    source (scripts/audio_vae_anchor.py, tests/test_audio_vae_quality)."""
    b, T, C = full
    t = np.arange(T, dtype=np.float32) / 44100.0
    out = np.empty((b, T, C), np.float32)
    for i in range(b):
        n_part = rs.randint(3, 7)
        freqs = rs.uniform(80.0, 6000.0, n_part).astype(np.float32)
        amps = rs.uniform(0.1, 0.6, n_part).astype(np.float32)
        amps /= max(1.0, amps.sum() / 0.8)
        wave = np.zeros((T, C), np.float32)
        for f, a in zip(freqs, amps):
            ph = rs.uniform(0, 2 * np.pi, C).astype(np.float32)
            # slight stereo detune for channel decorrelation
            det = rs.uniform(0.995, 1.005, C).astype(np.float32)
            wave += a * np.sin(2 * np.pi * f * det[None, :]
                               * t[:, None] + ph[None, :])
        wave += 0.01 * rs.randn(T, C).astype(np.float32)
        out[i] = np.clip(wave, -1.0, 1.0)
    return out


class SyntheticLoader:
    def __init__(self, batch_size: int, spec, seed: int = 0,
                 mixed: bool = False):
        """spec: list of (shape_without_batch, kind) where kind in
        {'normal', 'binary', 'flag'}. With ``mixed``, the last column must
        be a 'flag' [b] bool mask and the mouse/btn columns (index -3/-2)
        are zeroed where the flag is False (unlabelled rows, reference
        s3_cod_latent_mixed.py:190-193)."""
        self.batch_size = batch_size
        self.spec = spec
        self.seed = seed
        self.mixed = mixed

    def __iter__(self):
        rs = np.random.RandomState(self.seed)
        while True:
            out = []
            for shape, kind in self.spec:
                full = (self.batch_size,) + tuple(shape)
                if kind == "flag":
                    out.append(rs.rand(*full) > 0.5)
                elif kind == "binary":
                    out.append((rs.rand(*full) > 0.5).astype(np.float32))
                elif kind == "tones":
                    out.append(_tone_batch(full, rs))
                else:
                    out.append(rs.randn(*full).astype(np.float32))
            if self.mixed:
                flags = out[-1]
                for col in (-3, -2):  # mouse, btn
                    out[col] = np.where(flags[:, None, None], out[col], 0.0
                                        ).astype(np.float32)
            yield out  # always a list, even for single-column specs


def get_loader(data_id, batch_size, window_length=16, channels=128,
               audio_channels=64, sample_size=8, n_buttons=11,
               n_mouse_axes=2, n_samples=88200,
               process_index: int = 0, **_):
    """``process_index`` is the batch rank (trainers pass
    ``mesh.batch_rank``, the index over data x fsdp): the stream is seeded
    1000 + it, so batch ranks draw distinct batches and the tensor and seq
    ranks of one batch rank, which split its heads or frames between
    them, the same batch."""
    seed = 1000 + process_index
    if data_id == "synthetic_latent":
        spec = [((window_length, channels, sample_size, sample_size), "normal"),
                ((window_length, n_mouse_axes), "normal"),
                ((window_length, n_buttons), "binary")]
    elif data_id == "synthetic_av":
        spec = [((window_length, channels, sample_size, sample_size), "normal"),
                ((window_length, audio_channels), "normal"),
                ((window_length, n_mouse_axes), "normal"),
                ((window_length, n_buttons), "binary")]
    elif data_id == "synthetic_mixed":
        # [vid, audio, mouse, btn, has_controls] — reference collate order
        spec = [((window_length, channels, sample_size, sample_size), "normal"),
                ((window_length, audio_channels), "normal"),
                ((window_length, n_mouse_axes), "normal"),
                ((window_length, n_buttons), "binary"),
                ((), "flag")]  # has_controls flag per sample
        return SyntheticLoader(batch_size, spec, seed, mixed=True)
    elif data_id == "synthetic_audio_latent":
        spec = [((window_length, channels), "normal")]
    elif data_id == "synthetic_waveform":
        spec = [((n_samples, 2), "normal")]
    elif data_id == "synthetic_tones":
        spec = [((n_samples, 2), "tones")]
    else:
        raise ValueError(f"Invalid synthetic data id: {data_id}")
    return SyntheticLoader(batch_size, spec, seed)
