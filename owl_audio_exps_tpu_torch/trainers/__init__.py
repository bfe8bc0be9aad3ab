"""Trainer registry (counterpart of owl_audio_exps_tpu/trainers/__init__.py)."""

_NEXT_TRAINING = ("av", "mixed_av", "audio_rft")
_SLICE_5 = ("causvid_vid", "sforce_vid", "ode_distill_vid", "audio_vae")


def get_trainer_cls(trainer_id: str):
    if trainer_id == "rft":
        from .rft_trainer import RFTTrainer
        return RFTTrainer
    if trainer_id in _NEXT_TRAINING:
        raise NotImplementedError(
            f"trainer {trainer_id!r} is not ported yet: the AV and audio "
            "trainers come next in the training slice (port slice 2, "
            "ROADMAP.md Queue 1)")
    if trainer_id in _SLICE_5:
        raise NotImplementedError(
            f"trainer {trainer_id!r} is not ported yet: distillation and "
            "the VAE trainer come with port slice 5 (ROADMAP.md Queue 1)")
    raise ValueError(f"Invalid trainer id: {trainer_id}")
