"""Sampler registry (counterpart of owl_audio_exps_tpu/sampling/__init__.py)."""

_NOT_PORTED = ("av_caching", "av_caching_v1", "av_causal", "av_causal_no_cfg",
               "av_causal_one_step", "av_caching_one_step")


def get_sampler_cls(sampler_id: str):
    if sampler_id == "av_window":
        from .av_window import AVWindowSampler
        return AVWindowSampler
    if sampler_id == "audio_caching":
        from .audio_caching import AudioCachingSampler
        return AudioCachingSampler
    if sampler_id in _NOT_PORTED:
        raise NotImplementedError(
            f"sampler {sampler_id!r} is not ported yet: the AV cached "
            "samplers are ROADMAP.md Queue 1 item 3")
    raise ValueError(f"Invalid sampler id: {sampler_id}")
