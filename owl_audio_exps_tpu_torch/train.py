"""Training entry point of the port:

    python -m owl_audio_exps_tpu_torch.train --config_path configs/dit_v4_tpu_e2e.yml --max_steps N
    python -m owl_audio_exps_tpu_torch.train --config_path configs/av_v5_8x8_weak.yml
    python -m owl_audio_exps_tpu_torch.train --config_path configs/audio.yml --max_steps 2
    python -m owl_audio_exps_tpu_torch.train --config_path configs/dit_v4_dmd.yml --max_steps 2
    python -m owl_audio_exps_tpu_torch.train --config_path configs/audio_vae.yml --max_steps 6

Runs on the card (``cuda``) unless ``--device cpu`` (or ``train.device``
in the config) asks for the CPU. Under ``torchrun`` each process takes
one device (its LOCAL_RANK) and the processes form the mesh of
``train.mesh``, with NCCL on the card and gloo on the CPU; for example
context-parallel dit_v4 at 98,304 tokens on four cards:

    torchrun --nproc_per_node 4 -m owl_audio_exps_tpu_torch.train --config_path configs/dit_v4_98k_sp.yml

and the 5B at its written fsdp 4 (parameters, EMA and optimizer state
sharded over the four cards; parallel/sharding.py):

    torchrun --nproc_per_node 4 -m owl_audio_exps_tpu_torch.train --config_path configs/dit_v4_5B.yml

The pipe axis (parallel/pipeline.py) runs a config with
``pipeline_parallel: true`` and ``mesh: {pipe: K}`` (mesh_smoke.py
``--case pipe`` trains the 5B so on three cards), context parallelism
the AV model (``sequence_parallel: true``, ``mesh: {seq: 4}``;
sp_smoke.py takes configs/av_v5_8x8_weak.yml), and the distillation
trainers run under any mesh of data, fsdp and tensor (mesh_smoke.py
``--case distill``).

What cannot run as configured is cut, and each cut is printed
(``port_cuts``): a
data loader that cannot read its data becomes the synthetic source with
the trainer's batch columns at the config's shapes (``synthetic_latent``
for ``rft``, ``synthetic_av`` for ``av``, ``synthetic_mixed`` for
``mixed_av``, and for ``audio_rft`` ``synthetic_audio_latent`` of
``sample_size`` latents, the latent window the model trains on; the
distillation trainers ``causvid_vid``, ``sforce_vid`` and
``ode_distill_vid`` take ``synthetic_latent``), and so does an eval
loader (``sample_data_id``, at its ``window_length``). Every loader is
ported: ``cod`` and ``sequence_packing`` are kept where their
``dataset_path`` exists, the S3 loaders (``cod_s3``, ``cod_s3_audio``,
``cod_s3_mixed``) where boto3 is installed, and the waveform loader
``local_waveform`` except for an ``audio_rft`` config that names no audio
VAE (``vae_ckpt_path`` / ``vae_cfg_path``, as configs/audio.yml), whose
waveforms would reach the model unencoded, and which takes
``synthetic_audio_latent``; a mesh axis (fsdp, tensor, seq, pipe) wider than
the processes that were started shrinks to what divides them; and an
eval sampler that the trainer's eval does not run is dropped (``rft`` and
the distillation trainers run the cached video samplers, ``av`` and
``mixed_av`` the window samplers, ``audio_rft`` ``audio_caching``). A
distillation config's ``teacher_cfg`` is a path the trainer reads, as the
JAX trainer does.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import List, Optional

# loaders of files read dataset_path; the S3 loaders need boto3
_TABLE_DATA = ("cod", "sequence_packing")
_S3_DATA = ("cod_s3", "cod_s3_audio", "cod_s3_mixed")
# the synthetic source with the batch columns each trainer reads
_SYNTHETIC_FOR = {"av": "synthetic_av", "mixed_av": "synthetic_mixed",
                  "audio_rft": "synthetic_audio_latent"}
# the eval samplers the port runs, by trainer
_VIDEO_SAMPLERS = ("av_caching", "av_caching_v1", "av_caching_one_step")
_AV_SAMPLERS = ("av_window", "av_causal", "av_causal_no_cfg",
                "av_causal_one_step")
_PORTED_EVAL = {"rft": _VIDEO_SAMPLERS, "av": _AV_SAMPLERS,
                "mixed_av": _AV_SAMPLERS, "audio_rft": ("audio_caching",),
                "causvid_vid": _VIDEO_SAMPLERS, "sforce_vid": _VIDEO_SAMPLERS,
                "ode_distill_vid": _VIDEO_SAMPLERS}


def _synthetic_shapes(synthetic: str, mc, window_length: int):
    """The batch shapes of the synthetic source ``synthetic``."""
    if synthetic == "synthetic_audio_latent":
        # the audio loader's window counts waveform samples; the model
        # trains on sample_size latents
        return dict(window_length=mc.sample_size, channels=mc.channels)
    shapes = dict(window_length=window_length, channels=mc.channels,
                  sample_size=mc.sample_size, n_buttons=mc.n_buttons,
                  n_mouse_axes=mc.get("n_mouse_axes", 2))
    if synthetic in ("synthetic_av", "synthetic_mixed"):
        shapes["audio_channels"] = mc.audio_channels
    return shapes


def _why_cut(tc, data_id: Optional[str], kw) -> Optional[str]:
    """Why the loader ``data_id`` (with kwargs ``kw``) cannot read its
    data, or None when it can."""
    if data_id in _TABLE_DATA:
        path = kw.get("dataset_path")
        if path and os.path.isdir(path):
            return None
        return f"its dataset_path {path!r} does not exist"
    if data_id in _S3_DATA:
        try:
            import boto3  # noqa: F401
        except ImportError:
            return "the S3 loaders need boto3, which is not installed"
        return None
    if data_id == "local_waveform" and tc.trainer_id == "audio_rft" \
            and not (tc.get("vae_ckpt_path") or tc.get("vae_cfg_path")):
        return ("the config names no audio VAE (vae_ckpt_path, "
                "vae_cfg_path), so its waveforms would reach the model "
                "unencoded")
    return None


def port_cuts(cfg, world_size: int) -> List[str]:
    """Apply the cuts this config needs to run on the port with
    ``world_size`` processes; returns one line per cut."""
    tc, mc = cfg.train, cfg.model
    cuts = []
    synthetic = _SYNTHETIC_FOR.get(tc.trainer_id, "synthetic_latent")
    for key in ("data_id", "sample_data_id"):
        data_id = tc.get(key)
        kw_key = key.replace("_id", "_kwargs")
        kw = dict((tc.get(kw_key) or {}).items())
        why = _why_cut(tc, data_id, kw)
        if why is None:
            continue
        shapes = _synthetic_shapes(synthetic, mc, kw.get("window_length",
                                                         mc.n_frames))
        cuts.append(f"{key} {data_id!r} -> {synthetic!r} {shapes} ({why})")
        tc[key], tc[kw_key] = synthetic, shapes
    mesh = dict((tc.get("mesh") or {}).items())
    # the fsdp, tensor, seq and pipe axes (in that order) keep what
    # divides the processes the data axis leaves them
    budget = max(world_size // max(mesh.get("data", 1), 1), 1)
    for axis in ("fsdp", "tensor", "seq", "pipe"):
        size = mesh.get(axis, 1)
        new = math.gcd(size, budget)
        budget //= new
        if new != size:
            cuts.append(f"mesh {axis} {size} -> {new} (the processes "
                        f"started: {world_size})")
            mesh[axis] = new
            tc.mesh = mesh
    if tc.get("sampler_id") and \
            tc.sampler_id not in _PORTED_EVAL.get(tc.trainer_id, ()):
        why = "this trainer's eval with it is not ported"
        if tc.trainer_id in ("av", "mixed_av") and \
                tc.sampler_id in _VIDEO_SAMPLERS:
            why = (f"the {tc.trainer_id} trainer's eval hands the video "
                   f"sampler the AV batch, and fails so in the JAX package "
                   f"too")
        cuts.append(f"sampler_id {tc.sampler_id!r} -> None ({why})")
        tc.sampler_id = None
    return cuts


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from .configs import Config
    from .parallel import dist as pdist
    from .trainers import get_trainer_cls

    cfg = Config.from_yaml(args.config_path)
    device = args.device or cfg.train.get("device") or "cuda"
    local_rank = pdist.init_distributed(device)
    try:
        world = pdist.process_count()
        if device == "cuda" and world > 1:
            device = f"cuda:{local_rank}"
        for line in port_cuts(cfg, world):
            if pdist.is_main():
                print(f"[train] cut: {line}", flush=True)
        trainer = get_trainer_cls(cfg.train.trainer_id)(cfg, device=device)
        trainer.train(max_steps=args.max_steps)
    finally:
        pdist.cleanup()


if __name__ == "__main__":
    main()
