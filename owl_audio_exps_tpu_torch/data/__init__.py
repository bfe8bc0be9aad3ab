"""Data registry (counterpart of owl_audio_exps_tpu/data/__init__.py).

The synthetic sources and the local waveform loader are ported; the file,
S3 and packing loaders of latents are not yet (ROADMAP.md Queue 1)."""

_NOT_PORTED = ("cod", "sequence_packing", "cod_s3", "cod_s3_audio",
               "cod_s3_mixed")


def get_loader(data_id: str, batch_size: int, **kwargs):
    if data_id and data_id.startswith("synthetic"):
        from .synthetic import get_loader as fn
        return fn(data_id, batch_size, **kwargs)
    if data_id == "local_waveform":
        from .local_waveform import get_loader as fn
        return fn(batch_size, **kwargs)
    if data_id in _NOT_PORTED:
        raise NotImplementedError(
            f"data_id {data_id!r} is not ported yet: the file and S3 "
            "loaders come with port slice 5 (ROADMAP.md Queue 1)")
    raise ValueError(f"Invalid data id: {data_id}")
