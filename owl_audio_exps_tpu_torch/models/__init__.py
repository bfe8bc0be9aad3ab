"""Model registry (counterpart of owl_audio_exps_tpu/models/__init__.py)."""

_NOT_PORTED = ("game_rft", "game_mft_audio", "audio_rft")


def get_core_cls(model_id: str):
    """Pure denoiser class for a model id."""
    if model_id == "game_rft_audio":
        from .gamerft_audio import GameRFTAudioCore
        return GameRFTAudioCore
    if model_id in _NOT_PORTED:
        raise NotImplementedError(
            f"model {model_id!r} is not ported yet (ROADMAP.md Queue 1)")
    raise ValueError(f"Invalid model id: {model_id}")
