"""Trainer registry (counterpart of owl_audio_exps_tpu/trainers/__init__.py)."""

_NOT_PORTED = ("causvid_vid", "sforce_vid", "ode_distill_vid",
               "audio_vae")


def get_trainer_cls(trainer_id: str):
    if trainer_id == "rft":
        from .rft_trainer import RFTTrainer
        return RFTTrainer
    if trainer_id == "av":
        from .rft_trainer import AVRFTTrainer
        return AVRFTTrainer
    if trainer_id == "mixed_av":
        from .rft_trainer import MixedAVRFTTrainer
        return MixedAVRFTTrainer
    if trainer_id == "audio_rft":
        from .rft_trainer import AudioRFTTrainer
        return AudioRFTTrainer
    if trainer_id in _NOT_PORTED:
        raise NotImplementedError(
            f"trainer {trainer_id!r} is not ported yet: distillation and "
            "the VAE trainer are queued in ROADMAP.md Queue 1 item 6")
    raise ValueError(f"Invalid trainer id: {trainer_id}")
