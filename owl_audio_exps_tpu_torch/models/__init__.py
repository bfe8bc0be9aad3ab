"""Model registry (counterpart of owl_audio_exps_tpu/models/__init__.py).

Each model is a Core/Wrapper pair: the Core is the pure denoiser used by
samplers; the wrapper owns training-time noising + loss."""


def get_model_cls(model_id: str):
    """Training wrapper class for a model id."""
    if model_id == "game_rft":
        from .gamerft import GameRFT
        return GameRFT
    if model_id == "game_rft_audio":
        from .gamerft_audio import GameRFTAudio
        return GameRFTAudio
    if model_id == "game_mft_audio":
        from .gamemft_audio import GameMFTAudio
        return GameMFTAudio
    if model_id == "audio_rft":
        from .audiorft import AudioRFT
        return AudioRFT
    raise ValueError(f"Invalid model id: {model_id}")


def get_core_cls(model_id: str):
    """Pure denoiser class for a model id."""
    if model_id == "game_rft":
        from .gamerft import GameRFTCore
        return GameRFTCore
    if model_id == "game_rft_audio":
        from .gamerft_audio import GameRFTAudioCore
        return GameRFTAudioCore
    if model_id == "game_mft_audio":
        from .gamemft_audio import GameMFTAudioCore
        return GameMFTAudioCore
    if model_id == "audio_rft":
        from .audiorft import AudioRFTCore
        return AudioRFTCore
    raise ValueError(f"Invalid model id: {model_id}")
