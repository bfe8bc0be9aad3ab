"""Trainer registry (counterpart of owl_audio_exps_tpu/trainers/__init__.py)."""


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
    if trainer_id == "causvid_vid":
        from .causvid import CausVidTrainer
        return CausVidTrainer
    if trainer_id == "sforce_vid":
        from .self_forcing import SelfForceTrainer
        return SelfForceTrainer
    if trainer_id == "ode_distill_vid":
        from .ode_distill import DistillODETrainer
        return DistillODETrainer
    if trainer_id == "audio_vae":
        from .audio_vae_trainer import AudioVAETrainer
        return AudioVAETrainer
    raise ValueError(f"Invalid trainer id: {trainer_id}")
