"""Data registry (counterpart of owl_audio_exps_tpu/data/__init__.py):
every data id of the JAX registry.

``process_index`` and ``process_count`` default to this process's batch
rank and the number of batch ranks (data x fsdp) of the port's mesh
(parallel/mesh.py), where the JAX package takes the JAX process and
shards the batch over data x fsdp (``batch_sharding``): batch ranks read
disjoint shards, and the tensor and seq ranks of one batch rank, which
split its heads or its frames between them, read the same one. ``cod_s3_audio`` maps
to the plain S3 loader, as in the JAX package.
"""


def get_loader(data_id: str, batch_size: int, **kwargs):
    from ..parallel.mesh import get_mesh
    mesh = get_mesh()
    kwargs.setdefault("process_index", mesh.batch_rank)
    kwargs.setdefault("process_count", mesh.batch_ranks)

    if data_id == "cod":
        from .cod_latent import get_loader as fn
    elif data_id == "sequence_packing":
        from .latent_seq_packing import get_loader as fn
    elif data_id in ("cod_s3", "cod_s3_audio"):
        from .s3_cod_latent import get_loader as fn
        kwargs.pop("process_count", None)
    elif data_id == "cod_s3_mixed":
        from .s3_cod_latent_mixed import get_loader as fn
        kwargs.pop("process_count", None)
    elif data_id == "local_waveform":
        from .local_waveform import get_loader as fn
    elif data_id and data_id.startswith("synthetic"):
        from .synthetic import get_loader as syn
        kwargs.pop("process_count", None)
        return syn(data_id, batch_size, **kwargs)
    else:
        raise ValueError(f"Invalid data id: {data_id}")
    return fn(batch_size=batch_size, **kwargs)
