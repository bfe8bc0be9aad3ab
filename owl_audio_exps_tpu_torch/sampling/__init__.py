"""Sampler registry (counterpart of owl_audio_exps_tpu/sampling/__init__.py):
the same ids, mapped to the port's classes."""


def get_sampler_cls(sampler_id: str):
    if sampler_id == "av_window":
        from .av_window import AVWindowSampler
        return AVWindowSampler
    if sampler_id == "av_caching":
        from .av_caching import AVCachingSamplerV2
        return AVCachingSamplerV2
    if sampler_id == "av_caching_v1":
        from .av_caching import AVCachingSampler
        return AVCachingSampler
    if sampler_id == "av_causal":
        from .av_window import CausalAVWindowSampler
        return CausalAVWindowSampler
    if sampler_id in ("av_causal_no_cfg", "av_causal_one_step"):
        from .av_window import CausalAVWindowSamplerNoCFG
        return CausalAVWindowSamplerNoCFG
    if sampler_id == "av_caching_one_step":
        from .av_caching import AVCachingOneStepSampler
        return AVCachingOneStepSampler
    if sampler_id == "audio_caching":
        from .audio_caching import AudioCachingSampler
        return AudioCachingSampler
    raise ValueError(f"Invalid sampler id: {sampler_id}")
